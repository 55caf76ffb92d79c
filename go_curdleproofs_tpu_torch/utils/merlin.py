"""Merlin transcripts over STROBE-128.

Byte-exact with the `merlin` crate / `jsign/merlin` Go port used by the
Go reference (transcript/transcript.go:11-19). The port's own copy of
go_curdleproofs_tpu/utils/merlin.py.
"""

from __future__ import annotations

import struct

from .strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _u32le(n: int) -> bytes:
    return struct.pack("<I", n)


class MerlinTranscript:
    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, n: int) -> None:
        self.append_message(label, struct.pack("<Q", n))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(n), True)
        return self.strobe.prf(n, False)
