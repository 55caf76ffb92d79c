"""The protocol's seeded generator (common/rand.go of the Go reference):
SHAKE256 over the 8-byte big-endian seed, read as one stream. Fr draws take
32 bytes and reject values >= r; a permutation is Fisher-Yates with 16
bytes a step, of which the first two are a big-endian u16 taken mod i + 1.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List

from .bls import R


class Rand:
    def __init__(self, seed: int):
        self._seed = struct.pack(">Q", seed)
        self._pos = 0
        self._buf = b""

    def read(self, n: int) -> bytes:
        end = self._pos + n
        if end > len(self._buf):
            self._buf = hashlib.shake_256(self._seed).digest(
                max(4096, 2 * end))
        out = self._buf[self._pos:end]
        self._pos = end
        return out

    def fr(self) -> int:
        while True:
            v = int.from_bytes(self.read(32), "big")
            if v < R:
                return v

    def frs(self, n: int) -> List[int]:
        return [self.fr() for _ in range(n)]

    def permutation(self, n: int) -> List[int]:
        perm = list(range(n))
        for i in range(n):
            j = struct.unpack(">H", self.read(16)[:2])[0] % (i + 1)
            perm[i], perm[j] = perm[j], perm[i]
        return perm
