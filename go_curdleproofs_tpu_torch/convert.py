"""State carried between the JAX package and the port, as numpy arrays and
Python ints (this module imports neither jax nor the JAX package).

Three forms cross:
  * RNS channel arrays of the JAX package's device state ->
    `pointvec_from_jax`;
  * canonical projective coordinates, as the JAX package's `to_ints` gives
    them per plane -> `pointvec_from_ints`, and back with `pointvec_to_ints`;
  * a CRS as affine int pairs (None for infinity) -> `crs_from_affine`,
    and back with `crs_to_affine`.

The JAX package holds a field element as 74 RNS channels: residues modulo
the 74 largest 11-bit primes, in descending order, of which the first 37
form base B1 with product M1 (go_curdleproofs_tpu/ops/rns.py:63-88). Its
values are in Montgomery form x*M1 mod p, possibly unreduced (below a small
multiple of p, far below M1). The primes are re-derived here by that rule.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import curdleproof
from .ops import curve, fp
from .utils.field_host import P

RNS_PRIME_BITS = 11
RNS_BASE = 37                  # primes per base; the array holds two bases


def _rns_primes() -> List[int]:
    out = []
    n = (1 << RNS_PRIME_BITS) - 1
    while len(out) < 2 * RNS_BASE:
        if all(n % d for d in range(2, int(n ** 0.5) + 1)):
            out.append(n)
        n -= 1
    return out


_B1 = _rns_primes()[:RNS_BASE]
_M1 = math.prod(_B1)
# CRT: v = sum_j r_j * w_j mod M1 with w_j = (M1/q_j) * ((M1/q_j)^-1 mod q_j)
_CRT_W = [(_M1 // q) * pow(_M1 // q, -1, q) for q in _B1]
_M1_INV_P = pow(_M1, -1, P)


def _ints_from_rns(ch: np.ndarray) -> List[int]:
    """[..., 74] RNS channels (M1-Montgomery form) -> canonical ints."""
    arr = np.asarray(ch).reshape(-1, 2 * RNS_BASE)[:, :RNS_BASE]
    rows = arr.astype(np.int64).tolist()
    return [sum(r * w for r, w in zip(row, _CRT_W)) % _M1 % P * _M1_INV_P % P
            for row in rows]


def pointvec_from_jax(x_ch: np.ndarray, y_ch: np.ndarray, z_ch: np.ndarray,
                      *, device: torch.device) -> curve.PointVec:
    """The JAX package's PointVec channel arrays (numpy [..., 74]) -> the
    port's PointVec with the same batch shape, on `device`."""
    batch = np.asarray(x_ch).shape[:-1]

    def conv(ch):
        return fp.from_ints(_ints_from_rns(ch), device).reshape(
            batch + (fp.NWORDS,))

    return curve.PointVec(conv(x_ch), conv(y_ch), conv(z_ch))


def pointvec_from_ints(xs: Sequence[int], ys: Sequence[int],
                       zs: Sequence[int], shape: Tuple[int, ...], *,
                       device: torch.device) -> curve.PointVec:
    """Canonical projective coordinates (flat sequences of ints, one per
    point, as the JAX package's `to_ints` gives each plane) -> the port's
    PointVec of batch shape `shape` on `device`."""
    def conv(vals):
        return fp.from_ints([int(v) for v in np.asarray(vals, dtype=object)
                             .reshape(-1)], device).reshape(
                                 tuple(shape) + (fp.NWORDS,))

    return curve.PointVec(conv(xs), conv(ys), conv(zs))


def pointvec_to_ints(pv: curve.PointVec) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """The port's PointVec -> three object arrays of canonical ints with the
    PointVec's batch shape (what `pointvec_from_ints` takes)."""
    shape = tuple(pv.batch_shape)

    def conv(t):
        out = np.empty(math.prod(shape), dtype=object)
        out[:] = fp.to_ints(t)
        return out.reshape(shape)

    return conv(pv.x), conv(pv.y), conv(pv.z)


AffineInts = Optional[Tuple[int, int]]


def crs_from_affine(gs: Sequence[AffineInts], hs: Sequence[AffineInts],
                    h: AffineInts, gt: AffineInts, gu: AffineInts,
                    gsum: AffineInts, hsum: AffineInts) -> curdleproof.CRS:
    """A CRS given as affine int pairs -> the port's curdleproof.CRS."""
    def pt(a):
        return None if a is None else (int(a[0]), int(a[1]))

    return curdleproof.CRS([pt(g) for g in gs], [pt(x) for x in hs], pt(h),
                           pt(gt), pt(gu), pt(gsum), pt(hsum))


def crs_to_affine(crs: curdleproof.CRS) -> Dict[str, object]:
    """The port's CRS -> keyword arguments of affine int pairs, as
    `crs_from_affine` (or the JAX package's CRS dataclass) takes them."""
    return dict(gs=list(crs.gs), hs=list(crs.hs), h=crs.h, gt=crs.gt,
                gu=crs.gu, gsum=crs.gsum, hsum=crs.hsum)
