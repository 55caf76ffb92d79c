"""Every number a run draws comes from its --seed through `derive`."""

from __future__ import annotations

import hashlib


def derive(seed: int, *labels) -> int:
    """A 64-bit value for (seed, labels): the seed of one Rand, one pick."""
    text = ":".join(str(x) for x in (seed,) + labels).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "big")
