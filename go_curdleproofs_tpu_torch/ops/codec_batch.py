"""Batched point decompression and subgroup checking on a device.

The verifier decodes every compressed point of a proof and its trackers,
and the prover its pre-trackers, in one launch of the `decode_points`
kernel (ops/kernels.py): the square root of x^3 + 4 with the sign the
flags ask for, the on-curve flag and Scott's subgroup test [lambda]P ==
phi(P) (ops/glv.py), then one fetch. Byte semantics match
`codec.g1_from_bytes`, including its ValueErrors.

A decode is one `decode` span (utils/profiling.py) with the children
`parse`, `upload`, `fetch` and `convert`, and the counters
`decode.points` (points decoded) and `decode.lanes` (point slots the
kernel launches).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..utils import field_host as fh
from ..utils import profiling
from ..utils.field_host import Affine
from . import curve, fp, glv, kernels

_M_MASK = 0b111 << 5
_M_COMPRESSED_SMALLEST = 0b100 << 5
_M_COMPRESSED_LARGEST = 0b101 << 5
_M_COMPRESSED_INFINITY = 0b110 << 5


def _lambda_digits(n_lanes: int, device: torch.device) -> torch.Tensor:
    """Digits of an honest [lambda]P per lane (phi lanes zero: the subgroup
    test must not route through the endomorphism it checks)."""
    with profiling.span("recode"):
        digits = glv.digits_nophi(glv.LAMBDA, n_lanes)
    return curve._digits(digits, device)


def _subgroup_diffs(pv: curve.PointVec):
    """d1 = X_s - beta*x*Z_s and d2 = Y_s - y*Z_s for S = [lambda]P
    (affine P): both zero iff [lambda]P == phi(P)."""
    n = pv.x.shape[0]
    s = curve.scalar_mul_device(pv, _lambda_digits(n, pv.x.device))
    bx = fp.mul(pv.x, curve._beta_elem(pv.x.device))
    return fp.sub(s.x, fp.mul(bx, s.z)), fp.sub(s.y, fp.mul(pv.y, s.z))


def batch_subgroup_check(points: Sequence[Affine], *,
                         device: torch.device) -> bool:
    """All points in the prime-order subgroup? One batched program."""
    pts = [p for p in points if p is not None]
    if not pts:
        return True
    n = curve._pad_pow2(len(pts))
    pv = curve.from_affine_host(pts + [None] * (n - len(pts)), device=device)
    d1, d2 = _subgroup_diffs(pv)
    ok = fp.is_zero(d1) & fp.is_zero(d2)
    with profiling.span("fetch"):
        ok = ok.cpu()
    return bool(ok[: len(pts)].all())


@profiling.traced("decode")
def batch_decompress(blobs: Sequence[bytes], *, device: torch.device,
                     subgroup_check: bool = True) -> List[Affine]:
    """Decode 48-byte compressed G1 points: host flag and canonicality
    parsing, then one upload of the x bytes, one `decode_points` launch
    (sqrt + on-curve + y-select + subgroup) and one fetch."""
    results: List[Affine] = [None] * len(blobs)
    idxs: List[int] = []
    xs: List[int] = []
    packed = bytearray()          # the x bytes, then a sign byte a point
    wants_largest = bytearray()
    with profiling.span("parse"):
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
            packed += xb
            wants_largest.append(meta == _M_COMPRESSED_LARGEST)
    if not xs:
        return results

    n = len(xs)
    profiling.count("decode.points", n)
    profiling.count("decode.lanes", kernels.decode_slots(n))
    with profiling.span("upload"):
        packed += wants_largest
        dev = torch.frombuffer(packed, dtype=torch.uint8).to(device)
    out = kernels.decode_points(dev[:kernels.XBYTES * n].view(n, -1),
                                dev[kernels.XBYTES * n:])
    with profiling.span("fetch"):
        out = out.cpu()
    with profiling.span("convert"):
        words = out.numpy()
        flags = words[:, fp.NWORDS]
        raw = words[:, :fp.NWORDS].tobytes()
        ys = [int.from_bytes(raw[48 * k:48 * k + 48], "little")
              for k in range(n)]
    if not (flags & kernels.ON_CURVE).all():
        raise ValueError("point not on curve")
    if subgroup_check and not (flags & kernels.IN_SUBGROUP).all():
        raise ValueError("point not in prime-order subgroup")
    for i, x, y in zip(idxs, xs, ys):
        results[i] = (x, y)
    return results
