"""Batched point decompression and subgroup checking on a device.

The verifier decodes every compressed point of a proof and its trackers in
one batched program: the sqrt ladder (the `pow_fixed` kernel), on-curve
validation, lexicographic y selection, and Scott's half-width subgroup test
[lambda]P == phi(P) (ops/glv.py), then one fetch. Byte semantics match
`codec.g1_from_bytes`, including its ValueErrors.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils import field_host as fh
from ..utils.field_host import Affine
from . import curve, fp, glv

_M_MASK = 0b111 << 5
_M_COMPRESSED_SMALLEST = 0b100 << 5
_M_COMPRESSED_LARGEST = 0b101 << 5
_M_COMPRESSED_INFINITY = 0b110 << 5


def _lambda_digits(n_lanes: int, device: torch.device) -> torch.Tensor:
    """Digits of an honest [lambda]P per lane (phi lanes zero: the subgroup
    test must not route through the endomorphism it checks)."""
    return curve._digits(glv.digits_nophi(glv.LAMBDA, n_lanes), device)


def _subgroup_diffs(pv: curve.PointVec):
    """d1 = X_s - beta*x*Z_s and d2 = Y_s - y*Z_s for S = [lambda]P
    (affine P): both zero iff [lambda]P == phi(P)."""
    n = pv.x.shape[0]
    s = curve.scalar_mul_device(pv, _lambda_digits(n, pv.x.device))
    bx = fp.mul(pv.x, curve._beta_elem(pv.x.device))
    return fp.sub(s.x, fp.mul(bx, s.z)), fp.sub(s.y, fp.mul(pv.y, s.z))


def _decode_program(xe: torch.Tensor,
                    want_largest: torch.Tensor) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """x coordinates [n] -> (y [n] elements, ok [n] bool): y is the
    sign-selected square root of x^3 + 4, ok = on-curve and in-subgroup."""
    device = xe.device
    rhs = fp.add(fp.mul(fp.mul(xe, xe), xe),
                 fp.constant(fh.B_COEFF, xe.shape[:-1], device=device))
    cand = fp.sqrt_candidate(rhs)
    on_curve = fp.is_zero(fp.sub(fp.mul(cand, cand), rhs))
    flip = fp.lex_gt_half(cand) != want_largest
    y = fp.where(flip, fp.neg(cand), cand)
    one = fp.constant(1, xe.shape[:-1], device=device)
    d1, d2 = _subgroup_diffs(curve.PointVec(xe, y, one))
    return y, on_curve & fp.is_zero(d1) & fp.is_zero(d2)


def batch_subgroup_check(points: Sequence[Affine], *,
                         device: torch.device) -> bool:
    """All points in the prime-order subgroup? One batched program."""
    pts = [p for p in points if p is not None]
    if not pts:
        return True
    n = curve._pad_pow2(len(pts))
    pv = curve.from_affine_host(pts + [None] * (n - len(pts)), device=device)
    d1, d2 = _subgroup_diffs(pv)
    ok = (fp.is_zero(d1) & fp.is_zero(d2)).cpu()
    return bool(ok[: len(pts)].all())


def batch_decompress(blobs: Sequence[bytes], *, device: torch.device,
                     subgroup_check: bool = True) -> List[Affine]:
    """Decode 48-byte compressed G1 points: host flag and canonicality
    parsing, then one device program (sqrt + on-curve + y-select +
    subgroup) and one fetch."""
    results: List[Affine] = [None] * len(blobs)
    idxs: List[int] = []
    xs: List[int] = []
    wants_largest: List[bool] = []
    for i, b in enumerate(blobs):
        if len(b) < 48:
            raise ValueError("short buffer for G1 point")
        meta = b[0] & _M_MASK
        if meta == _M_COMPRESSED_INFINITY:
            if any(bytes([b[0] & ~_M_MASK & 0xFF]) + bytes(b[1:48])):
                raise ValueError("invalid infinity encoding")
            continue
        if meta not in (_M_COMPRESSED_SMALLEST, _M_COMPRESSED_LARGEST):
            raise ValueError(f"invalid point encoding flags: {b[0]:#x}")
        xb = bytearray(b[:48])
        xb[0] &= ~_M_MASK & 0xFF
        x = int.from_bytes(xb, "big")
        if x >= fh.P:
            raise ValueError("x coordinate not canonical")
        idxs.append(i)
        xs.append(x)
        wants_largest.append(meta == _M_COMPRESSED_LARGEST)
    if not xs:
        return results

    n = curve._pad_pow2(len(xs))
    xe = fp.from_ints(xs + [1] * (n - len(xs)), device)   # pad with x=1 lanes
    wl = torch.from_numpy(
        np.array(wants_largest + [False] * (n - len(xs)))).to(device)
    y, ok = _decode_program(xe, wl)
    ys = fp.to_ints(y[: len(xs)])
    ok = ok[: len(xs)].cpu()
    for i, x, yv in zip(idxs, xs, ys):
        if yv * yv % fh.P != (x * x % fh.P * x + fh.B_COEFF) % fh.P:
            raise ValueError("point not on curve")
        results[i] = (x, yv)
    if subgroup_check and not bool(ok.all()):
        # on-curve failures raised above; what is left fails the subgroup
        raise ValueError("point not in prime-order subgroup")
    return results
