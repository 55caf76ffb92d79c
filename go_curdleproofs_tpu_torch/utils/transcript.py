"""Curdleproofs Fiat-Shamir transcript.

The port's own copy of go_curdleproofs_tpu/utils/transcript.py; mirrors
transcript/transcript.go of the Go reference byte for byte:
  * points are absorbed as 48-byte ZCash-compressed affine encodings;
  * scalars as 32-byte big-endian;
  * challenges are 32-byte PRF outputs rejection-sampled until canonical Fr,
    and each accepted challenge is appended back into the transcript
    (transcript.go:48-58 — required for cross-implementation compatibility).
"""

from __future__ import annotations

from typing import List

from . import codec
from . import field_host as fh
from . import strobe
from .field_host import Affine
from .merlin import MerlinTranscript


class Transcript:
    __slots__ = ("inner",)

    def __init__(self, label: bytes):
        self.inner = MerlinTranscript(label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.inner.append_message(label, message)

    def _append_bulk(self, label: bytes, msgs: List[bytes],
                     msg_len: int) -> None:
        """Absorb equal-length messages under one label: ONE native C call
        for the whole group (native/strobe.c) when available — the verifier
        replays ~3k point/scalar messages per proof."""
        if strobe.has_native_bulk() and len(msgs) > 1:
            strobe.native_append_msgs(self.inner.strobe, label,
                                      b"".join(msgs), msg_len, len(msgs))
        else:
            for m in msgs:
                self.inner.append_message(label, m)

    def append_points(self, label: bytes, *points: Affine) -> None:
        self._append_bulk(label, [codec.point_bytes(pt) for pt in points],
                          codec.G1_COMPRESSED_SIZE)

    def append_scalars(self, label: bytes, *scalars: int) -> None:
        self._append_bulk(label, [codec.fr_to_bytes(s) for s in scalars],
                          codec.FR_SIZE)

    def get_and_append_challenge(self, label: bytes) -> int:
        return self.get_and_append_challenges(label, 1)[0]

    def get_and_append_challenges(self, label: bytes, count: int) -> List[int]:
        """Rejection-sampled canonical challenges, each re-absorbed
        (transcript.go:48-58); one native C call for the whole vector."""
        if strobe.has_native_bulk():
            raw = strobe.native_challenges(self.inner.strobe, label, count)
            return [int.from_bytes(raw[i * 32:(i + 1) * 32], "big")
                    for i in range(count)]
        out = []
        for _ in range(count):
            while True:
                dest = self.inner.challenge_bytes(label, 32)
                v = int.from_bytes(dest, "big")
                if v < fh.R:
                    self.inner.append_message(label, codec.fr_to_bytes(v))
                    out.append(v)
                    break
        return out
