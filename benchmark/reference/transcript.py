"""The Curdleproofs Fiat-Shamir transcript in plain Python.

Keccak-f[1600], the mini-STROBE-128 that the `merlin` crate (and its Go
port jsign/merlin, which the Go reference uses) runs, Merlin framing, and
the Curdleproofs transcript: points absorbed as 48-byte compressed
encodings, scalars as 32 big-endian bytes, challenges rejection-sampled
until canonical in Fr and appended back (transcript/transcript.go).
"""

from __future__ import annotations

import struct
from typing import List

from . import bls

_MASK = (1 << 64) - 1
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation of lane A[x + 5y]
_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
        41, 45, 15, 21, 8, 18, 2, 61, 56, 14]
# rho-pi: lane i moves to _PI[i]: (x, y) -> (y, 2x + 3y)
_PI = [(i // 5) + 5 * ((2 * (i % 5) + 3 * (i // 5)) % 5) for i in range(25)]


def keccak_f1600(state: bytearray) -> None:
    """In place on a 200-byte state of 25 little-endian lanes."""
    a = list(struct.unpack("<25Q", state))
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ (((c[(x + 1) % 5] << 1) | (c[(x + 1) % 5] >> 63))
                                & _MASK) for x in range(5)]
        b = [0] * 25
        for i in range(25):
            v = a[i] ^ d[i % 5]
            r = _ROT[i]
            b[_PI[i]] = ((v << r) | (v >> (64 - r))) & _MASK if r else v
        for y in range(0, 25, 5):
            b0, b1, b2, b3, b4 = b[y:y + 5]
            a[y] = b0 ^ (~b1 & b2)
            a[y + 1] = b1 ^ (~b2 & b3)
            a[y + 2] = b2 ^ (~b3 & b4)
            a[y + 3] = b3 ^ (~b4 & b0)
            a[y + 4] = b4 ^ (~b0 & b1)
        a[0] ^= rc
    state[:] = struct.pack("<25Q", *a)


_RATE = 166                     # STROBE-128: 200 - 2 * 128 / 8 - 2
_F_I, _F_A, _F_C, _F_M = 1, 2, 4, 16


class Strobe128:
    """The operations Merlin uses: meta-AD, AD and PRF."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, _RATE + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_RATE + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        i = 0
        while i < len(data):
            take = min(_RATE - self.pos, len(data) - i)
            p = self.pos
            x = (int.from_bytes(self.state[p:p + take], "little")
                 ^ int.from_bytes(data[i:i + take], "little"))
            self.state[p:p + take] = x.to_bytes(take, "little")
            self.pos += take
            i += take
            if self.pos == _RATE:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            take = min(_RATE - self.pos, n - len(out))
            out += self.state[self.pos:self.pos + take]
            self.state[self.pos:self.pos + take] = bytes(take)
            self.pos += take
            if self.pos == _RATE:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError("STROBE continuation changed flags")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & _F_C and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_F_M | _F_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_F_A, more)
        self._absorb(data)

    def prf(self, n: int) -> bytes:
        self._begin_op(_F_I | _F_A | _F_C, False)
        return self._squeeze(n)


class Transcript:
    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(struct.pack("<I", len(message)), True)
        self.strobe.ad(message, False)

    def append_points(self, label: bytes, *points: bls.Affine) -> None:
        for p in points:
            self.append_message(label, bls.encode(p))

    def append_scalars(self, label: bytes, *scalars: int) -> None:
        for s in scalars:
            self.append_message(label, (s % bls.R).to_bytes(32, "big"))

    def challenge(self, label: bytes) -> int:
        while True:
            self.strobe.meta_ad(label, False)
            self.strobe.meta_ad(struct.pack("<I", 32), True)
            v = int.from_bytes(self.strobe.prf(32), "big")
            if v < bls.R:
                self.append_message(label, v.to_bytes(32, "big"))
                return v

    def challenges(self, label: bytes, count: int) -> List[int]:
        return [self.challenge(label) for _ in range(count)]
