"""Device-side point compression: projective -> 48-byte ZCash encoding
(go_curdleproofs_tpu/ops/compress_dev.py:39-94), byte-exact with
utils/codec.py `g1_to_bytes`.

The normalisation runs on the device: one inverse ladder over the Z plane
(`fp.inv`, the `pow_fixed` kernel with exponent p-2; Z = 0 gives 0), two
products, and the step out of Montgomery form (`fp.canonical_bytes_be`,
`fp.lex_gt_half`, the `mont_mul` kernel), so a download is 48 or 96 bytes a
point and the host does no inversion.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.field_host import Affine
from . import fp, halflimb
from .curve import PointVec

FLAG_SMALLEST = 0x80
FLAG_LARGEST = 0xA0
FLAG_INFINITY = 0xC0


@halflimb.device_cache()
def _inf_row(device: torch.device) -> torch.Tensor:
    """The 48-byte encoding of infinity on `device` (uploaded once)."""
    return halflimb.upload([FLAG_INFINITY] + [0] * 47, torch.uint8, device)


def _affine_bytes(points: PointVec):
    """(compressed blob [n, 48] uint8, y big-endian [n, 48] uint8): the
    rows of an infinity are the infinity encoding and zeros."""
    zinv = fp.inv(points.z)
    y = fp.mul(points.y, zinv)
    blob = fp.canonical_bytes_be(fp.mul(points.x, zinv))
    y_be = fp.canonical_bytes_be(y)
    flag = torch.where(fp.lex_gt_half(y), FLAG_LARGEST, FLAG_SMALLEST)
    blob[..., 0] |= flag.to(torch.uint8)
    is_inf = fp.is_zero(points.z)[..., None]
    return (torch.where(is_inf, _inf_row(blob.device), blob),
            torch.where(is_inf, torch.zeros_like(y_be), y_be))


def compress(points: PointVec) -> torch.Tensor:
    """[n] projective points -> [n, 48] uint8 compressed bytes."""
    return _affine_bytes(points)[0]


def compress_xy(points: PointVec) -> torch.Tensor:
    """[n] projective points -> [n, 96] uint8: the 48 compressed bytes
    followed by the affine y big-endian, so the host recovers (x, y) with
    no square root."""
    return torch.cat(_affine_bytes(points), dim=-1)


def decode_xy_host(row96: np.ndarray) -> Affine:
    """Host decode of one `compress_xy` row."""
    b = bytes(np.asarray(row96, dtype=np.uint8))
    if b[0] & FLAG_INFINITY == FLAG_INFINITY:
        return None
    return (int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big"),
            int.from_bytes(b[48:96], "big"))
