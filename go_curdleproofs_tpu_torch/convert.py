"""State carried between the JAX package and the port, as numpy arrays and
Python ints (this module imports neither jax nor the JAX package).

Six forms cross:
  * RNS channel arrays of the JAX package's device state ->
    `pointvec_from_jax`;
  * canonical projective coordinates, as the JAX package's `to_ints` gives
    them per plane -> `pointvec_from_ints`, and back with `pointvec_to_ints`;
  * a CRS as affine int pairs (None for infinity) -> `crs_from_affine`,
    and back with `crs_to_affine`;
  * scalar-field vectors: the JAX package's `fr.Element` limbs ([n, 33]
    base-256 limbs, any interval) <-> the port's [n, 8] Montgomery words,
    by canonical value: `fr_from_jax`, `fr_to_jax`;
  * GLV window digit arrays ([2n, 33] signed digits, the same layout on
    both sides): `digits_from_jax`, `digits_to_jax`;
  * a device transcript state: the JAX package's (state [200] int32 bytes,
    pos, pos_begin) <-> the port's `strobe_dev.TState`: `tstate_from_jax`,
    `tstate_to_jax`.

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
from .ops import curve, fp, fr, strobe_dev
from .utils.field_host import P, R

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


FR_JAX_LIMBS = 33              # base-256 limbs of the JAX package's fr.Element


def fr_from_jax(limbs: np.ndarray, *, device: torch.device) -> torch.Tensor:
    """The JAX package's fr.Element limbs (numpy [n, 33], base 256, signed
    or unreduced limbs allowed) -> the port's [n, 8] elements on `device`."""
    rows = np.asarray(limbs).reshape(-1, FR_JAX_LIMBS).astype(np.int64)
    return fr.from_ints([sum(int(v) << (8 * i) for i, v in enumerate(row)) % R
                         for row in rows.tolist()], device)


def fr_to_jax(x: torch.Tensor) -> np.ndarray:
    """The port's [n, 8] elements -> canonical base-256 limbs [n, 33] int32
    (the limbs of a CANONICAL fr.Element of the JAX package)."""
    return np.stack([np.frombuffer(v.to_bytes(FR_JAX_LIMBS, "little"),
                                   np.uint8).astype(np.int32)
                     for v in fr.to_ints(x)])


def digits_from_jax(digits: np.ndarray, *,
                    device: torch.device) -> torch.Tensor:
    """GLV window digits [..., 2n, W] as numpy -> int32 tensor on `device`."""
    return torch.from_numpy(np.array(digits, dtype=np.int32)).to(device)


def digits_to_jax(digits: torch.Tensor) -> np.ndarray:
    return digits.cpu().numpy().astype(np.int32)


def tstate_from_jax(st: np.ndarray, pos: int, pos_begin: int, *,
                    device: torch.device) -> strobe_dev.TState:
    """The JAX package's device transcript (state [200] int32 byte values,
    static pos and pos_begin) -> the port's TState on `device`."""
    state = torch.from_numpy(np.asarray(st).astype(np.uint8)).to(device)
    return strobe_dev.TState(state, int(pos), int(pos_begin))


def tstate_to_jax(ts: strobe_dev.TState) -> Tuple[np.ndarray, int, int]:
    return ts.st.cpu().numpy().astype(np.int32), ts.pos, ts.pos_begin
