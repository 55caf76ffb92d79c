"""Deterministic seeded randomness — SHAKE256 XOF.

The protocol's explicit random generator: a plain seeded object that the
caller creates and passes. The port's own copy of
go_curdleproofs_tpu/utils/rand.py, byte-exact with the Go reference's
common.Rand (common/rand.go):
  * seed = 8-byte big-endian u64 fed into SHAKE256;
  * GetFr: read 32 bytes, accept iff canonical big-endian Fr (rejection
    sampling);
  * random G1 points: generator times a random Fr;
  * GeneratePermutation: Fisher-Yates drawing 16 bytes per step, using the
    first two as a big-endian u16 mod (i+1) (common/rand.go:97-113).
"""

from __future__ import annotations

import hashlib
import struct
from typing import List

from . import field_host as fh
from .field_host import Affine


class Rand:
    def __init__(self, seed: int):
        self._seed = seed
        self._shake = hashlib.shake_256()
        self._shake.update(struct.pack(">Q", seed))
        self._consumed = 0
        self._buf = b""

    def __getstate__(self):
        """Pickled as its seed and position (the XOF object is not
        picklable), so that ranks of a process group can each take a copy
        that continues the same stream."""
        return self._seed, self._consumed

    def __setstate__(self, state):
        seed, consumed = state
        self.__init__(seed)
        self.read(consumed)

    def read(self, n: int) -> bytes:
        """Streaming squeeze: successive reads return successive XOF bytes.

        hashlib's shake digest(n) recomputes the WHOLE squeeze, so naive
        per-draw reads are O(stream^2) over the ~1.5k Fr draws of a large
        prove. Amortize with a doubling buffer (digest(N) is prefix-stable
        for SHAKE, so bytes never change)."""
        total = self._consumed + n
        if total > len(self._buf):
            new_len = max(4096, len(self._buf) * 2)
            while new_len < total:
                new_len *= 2
            self._buf = self._shake.digest(new_len)
        out = self._buf[self._consumed: total]
        self._consumed = total
        return out

    def get_fr(self) -> int:
        while True:
            data = self.read(32)
            v = int.from_bytes(data, "big")
            if v < fh.R:
                return v

    def get_frs(self, n: int) -> List[int]:
        return [self.get_fr() for _ in range(n)]

    def get_g1(self) -> Affine:
        return fh.g1_mul(fh.G1_GEN, self.get_fr())

    def get_g1s(self, n: int) -> List[Affine]:
        return [self.get_g1() for _ in range(n)]

    def generate_permutation(self, n: int) -> List[int]:
        perm = list(range(n))
        for i in range(n):
            buf = self.read(16)
            tmp = struct.unpack(">H", buf[:2])[0]
            j = tmp % (i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        return perm
