"""BLS12-381 wire codec — ZCash-format points, BE scalars, gnark framing.

The port's own copy of go_curdleproofs_tpu/utils/codec.py. Byte-exact with
gnark-crypto's Encoder/Decoder as used by the Go reference for every
Serialize/FromReader (whisk/types.go:41-72 and all proof serializers):

  * G1 compressed: 48 bytes, big-endian x; top 3 bits of byte 0 are flags:
      0b100 (0x80) compressed + y lexicographically smallest
      0b101 (0xA0) compressed + y lexicographically largest
      0b110 (0xC0) compressed point at infinity (rest zero)
  * fr.Element: 32 bytes big-endian.
  * slices: u32 big-endian length prefix, then elements.

Decoding validates on-curve and (optionally) prime-order subgroup membership,
like gnark's SetBytes. `g1_from_bytes` checks on the host; the verifier
defers its points into a `DecodePool`, which resolves them all in one
batched decode on its device (ops/codec_batch.py).
"""

from __future__ import annotations

import ctypes
import io
import struct
from typing import Dict, List, Optional

import torch

from . import field_host as fh
from . import native
from .field_host import Affine, P

G1_COMPRESSED_SIZE = 48
FR_SIZE = 32

_M_COMPRESSED_SMALLEST = 0b100 << 5
_M_COMPRESSED_LARGEST = 0b101 << 5
_M_COMPRESSED_INFINITY = 0b110 << 5
_M_UNCOMPRESSED = 0b000 << 5
_M_UNCOMPRESSED_INFINITY = 0b010 << 5
_M_MASK = 0b111 << 5


def g1_to_bytes(pt: Affine) -> bytes:
    """Compressed 48-byte encoding (gnark G1Affine.Bytes)."""
    if pt is None:
        out = bytearray(G1_COMPRESSED_SIZE)
        out[0] = _M_COMPRESSED_INFINITY
        return bytes(out)
    x, y = pt
    out = bytearray(x.to_bytes(G1_COMPRESSED_SIZE, "big"))
    if fh.fp_lexicographically_largest(y):
        out[0] |= _M_COMPRESSED_LARGEST
    else:
        out[0] |= _M_COMPRESSED_SMALLEST
    return bytes(out)


def g1_from_bytes(data: bytes, subgroup_check: bool = True) -> Affine:
    """Decode a compressed (or uncompressed) G1 point with validation."""
    if len(data) < G1_COMPRESSED_SIZE:
        raise ValueError("short buffer for G1 point")
    meta = data[0] & _M_MASK
    nat = native.lib()
    if nat is not None and meta not in (_M_UNCOMPRESSED,
                                        _M_UNCOMPRESSED_INFINITY):
        # the host library's single-point decode (native/codec.c), the
        # counterpart of gnark's assembly SetBytes
        xo = ctypes.create_string_buffer(48)
        yo = ctypes.create_string_buffer(48)
        rc = nat.g1_decompress(bytes(data[:48]), xo, yo)
        if rc == 1:
            return None
        if rc < 0:
            raise ValueError(f"invalid point encoding (native rc={rc})")
        if subgroup_check and nat.g1_subgroup_check(xo.raw, yo.raw) != 1:
            raise ValueError("point not in prime-order subgroup")
        return (int.from_bytes(xo.raw, "big"), int.from_bytes(yo.raw, "big"))
    if meta == _M_COMPRESSED_INFINITY:
        if any(b for b in bytes([data[0] & ~_M_MASK & 0xFF]) + data[1:G1_COMPRESSED_SIZE]):
            raise ValueError("invalid infinity encoding")
        return None
    if meta in (_M_UNCOMPRESSED, _M_UNCOMPRESSED_INFINITY):
        return _g1_from_uncompressed(data, subgroup_check)
    if meta not in (_M_COMPRESSED_SMALLEST, _M_COMPRESSED_LARGEST):
        raise ValueError(f"invalid point encoding flags: {data[0]:#x}")
    xb = bytearray(data[:G1_COMPRESSED_SIZE])
    xb[0] &= ~_M_MASK & 0xFF
    x = int.from_bytes(xb, "big")
    if x >= P:
        raise ValueError("x coordinate not canonical")
    y = fh.fp_sqrt((x * x * x + fh.B_COEFF) % P)
    if y is None:
        raise ValueError("point not on curve")
    if fh.fp_lexicographically_largest(y) != (meta == _M_COMPRESSED_LARGEST):
        y = P - y
    pt = (x, y)
    if subgroup_check and not fh.g1_in_subgroup(pt):
        raise ValueError("point not in prime-order subgroup")
    return pt


def g1_to_bytes_uncompressed(pt: Affine) -> bytes:
    if pt is None:
        out = bytearray(96)
        out[0] = _M_UNCOMPRESSED_INFINITY
        return bytes(out)
    x, y = pt
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def _g1_from_uncompressed(data: bytes, subgroup_check: bool) -> Affine:
    if len(data) < 96:
        raise ValueError("short buffer for uncompressed G1 point")
    meta = data[0] & _M_MASK
    if meta == _M_UNCOMPRESSED_INFINITY:
        return None
    xb = bytearray(data[:48])
    xb[0] &= ~_M_MASK & 0xFF
    x = int.from_bytes(xb, "big")
    y = int.from_bytes(data[48:96], "big")
    if x >= P or y >= P:
        raise ValueError("coordinate not canonical")
    pt = (x, y)
    if not fh.g1_is_on_curve(pt):
        raise ValueError("point not on curve")
    if subgroup_check and not fh.g1_in_subgroup(pt):
        raise ValueError("point not in prime-order subgroup")
    return pt


def fr_to_bytes(x: int) -> bytes:
    return (x % fh.R).to_bytes(FR_SIZE, "big")


def fr_from_bytes(data: bytes) -> int:
    """gnark Decoder semantics for fr.Element: big-endian, reduced mod r."""
    if len(data) < FR_SIZE:
        raise ValueError("short buffer for fr element")
    return int.from_bytes(data[:FR_SIZE], "big") % fh.R


def fr_from_bytes_canonical(data: bytes) -> int:
    """SetBytesCanonical: reject values >= r (transcript / Rand rejection)."""
    v = int.from_bytes(data[:FR_SIZE], "big")
    if v >= fh.R:
        raise ValueError("non-canonical scalar")
    return v


class Encoder:
    """gnark-style encoder: points compressed, u32 BE length-prefixed slices."""

    def __init__(self, w: io.BufferedIOBase):
        self.w = w

    def write_point(self, pt: Affine) -> None:
        if isinstance(pt, LazyPoint):
            self.w.write(pt.blob)
            return
        self.w.write(g1_to_bytes(pt))

    def write_points(self, pts: List[Affine]) -> None:
        self.w.write(struct.pack(">I", len(pts)))
        for pt in pts:
            self.write_point(pt)

    def write_fr(self, x: int) -> None:
        self.w.write(fr_to_bytes(x))


class LazyPoint:
    """A compressed point whose decompression is deferred into a batched
    device decode (utils/codec.py DecodePool).

    The verifier only ever needs most points as (a) transcript bytes —
    the blob itself — and (b) MSM-accumulator dict keys — blob equality IS
    point equality for canonical encodings. The final MSM reads the point
    on the device, by its row of `pool.pts`; only a host group op needs
    its ints (`resolve()`). The first of either materializes the WHOLE
    pool (one device sqrt/subgroup program + one fetch for every pooled
    point of a verification or a batch)."""

    __slots__ = ("blob", "pool")

    def __init__(self, blob: bytes, pool: "DecodePool"):
        self.blob = blob
        self.pool = pool

    @property
    def is_infinity(self) -> bool:
        return (self.blob[0] & _M_MASK) == _M_COMPRESSED_INFINITY

    def resolve(self) -> Affine:
        return self.pool.get(self.blob)

    def __eq__(self, other):
        # NOTE: no LazyPoint == tuple comparison — hash(LazyPoint) is
        # hash(blob), which differs from hash(tuple), and defining equality
        # where hashes disagree breaks dict/set semantics (the MSM
        # accumulator keys on points). Compare point_bytes() explicitly
        # when cross-representation equality is needed.
        if isinstance(other, LazyPoint):
            return self.blob == other.blob
        if other is None:
            return self.is_infinity
        return NotImplemented

    def __hash__(self):
        return hash(self.blob)

    def __repr__(self):
        return f"LazyPoint({self.blob[:4].hex()}..)"


def resolve_point(p):
    """LazyPoint | Affine | None -> Affine | None."""
    return p.resolve() if isinstance(p, LazyPoint) else p


def point_is_infinity(p) -> bool:
    if isinstance(p, LazyPoint):
        return p.is_infinity
    return p is None


def point_bytes(p) -> bytes:
    """Compressed wire bytes of a LazyPoint (free) or an Affine."""
    if isinstance(p, LazyPoint):
        return p.blob
    return g1_to_bytes(p)


class DecodePool:
    """Blob-deduplicated deferred decode set; ONE batched decompression on
    `device` (sqrt + on-curve + subgroup, ops/codec_batch.py) for
    everything at first resolve. The decoded points stay on the device
    (`pts`), where the verifier's final MSM reads them by `row`; the host
    builds the ints of the few points it resolves."""

    def __init__(self, device: torch.device):
        self.device = device
        self._blobs: Dict[bytes, int] = {}      # blob -> index in the decode
        self._decoded = None
        self._done = False

    def add(self, blob: bytes) -> LazyPoint:
        # the cheap host-side validations happen eagerly (flag bits,
        # canonical x, infinity padding) so malformed bytes fail at parse
        # time exactly like the eager decoder
        if len(blob) < G1_COMPRESSED_SIZE:
            raise ValueError("short buffer for G1 point")
        meta = blob[0] & _M_MASK
        if meta == _M_COMPRESSED_INFINITY:
            if any(bytes([blob[0] & ~_M_MASK & 0xFF]) + blob[1:48]):
                raise ValueError("invalid infinity encoding")
        elif meta in (_M_COMPRESSED_SMALLEST, _M_COMPRESSED_LARGEST):
            xb = bytearray(blob[:48])
            xb[0] &= ~_M_MASK & 0xFF
            if int.from_bytes(xb, "big") >= P:
                raise ValueError("x coordinate not canonical")
        else:
            raise ValueError(f"invalid point encoding flags: {blob[0]:#x}")
        blob = bytes(blob[:48])
        if blob not in self._blobs:
            if self._done:
                raise ValueError("DecodePool already materialized")
            self._blobs[blob] = len(self._blobs)
        return LazyPoint(blob, self)

    def materialize(self) -> None:
        if self._done:
            return
        from ..ops import codec_batch
        self._decoded = codec_batch.batch_decompress(list(self._blobs),
                                                     device=self.device)
        self._done = True

    def get(self, blob: bytes) -> Affine:
        self.materialize()
        return self._decoded[self._blobs[blob]]

    @property
    def pts(self) -> Optional[torch.Tensor]:
        """[3, n, 12]: the n decoded points (every blob but the infinity
        encoding) as the planes X, Y, Z in Montgomery form on `device`;
        None when the pool holds no such point."""
        self.materialize()
        return self._decoded.pts

    def row(self, blob: bytes) -> Optional[int]:
        """The blob's row of `pts`; None for the infinity encoding."""
        self.materialize()
        return self._decoded.row(self._blobs[blob])


class Decoder:
    def __init__(self, r: io.BufferedIOBase, subgroup_check: bool = True):
        self.r = r
        self.subgroup_check = subgroup_check
        # a DecodePool attached to the stream defers all point decodes
        # into one batched device decompression (verification hot path)
        self.pool = getattr(r, "_curdle_pool", None)

    def _read(self, n: int) -> bytes:
        data = self.r.read(n)
        if data is None or len(data) != n:
            raise ValueError("unexpected EOF")
        return data

    def read_point(self) -> Affine:
        blob = self._read(G1_COMPRESSED_SIZE)
        if self.pool is not None:
            return self.pool.add(blob)
        return g1_from_bytes(blob, self.subgroup_check)

    def read_points(self) -> List[Affine]:
        (n,) = struct.unpack(">I", self._read(4))
        return [self.read_point() for _ in range(n)]

    def read_fr(self) -> int:
        return fr_from_bytes(self._read(FR_SIZE))
