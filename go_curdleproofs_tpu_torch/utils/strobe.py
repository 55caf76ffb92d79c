"""STROBE-128 (Keccak-f[1600]-based) — the duplex construction under Merlin.

Byte-exact reimplementation of the mini-STROBE used by the `merlin` crate and
its Go port `jsign/merlin` (the Go reference's transcript backend,
transcript/transcript.go:8). Only the operations Merlin needs are
implemented: meta-AD, AD, PRF, KEY. The port's own copy of
go_curdleproofs_tpu/utils/strobe.py.
"""

from __future__ import annotations

import ctypes

from . import keccak, native

STROBE_R = 166  # rate in bytes: 200 - 2*security/8 - 2 = 166 for sec=128

# Bulk transcript ops of the host library (native/strobe.c): one C call
# absorbs a whole label-group of messages or squeezes a vector of
# rejection-sampled challenges; a verification replays ~3k messages.


def has_native_bulk() -> bool:
    return native.lib() is not None


def _native_call(strobe: "Strobe128", fn, *args) -> None:
    """Run a native op in-place on the strobe's state + position fields."""
    buf = (ctypes.c_char * 200).from_buffer(strobe.state)
    pos3 = (ctypes.c_int32 * 3)(strobe.pos, strobe.pos_begin,
                                strobe.cur_flags)
    fn(buf, pos3, *args)
    strobe.pos, strobe.pos_begin, strobe.cur_flags = (
        int(pos3[0]), int(pos3[1]), int(pos3[2]))


def native_append_msgs(strobe: "Strobe128", label: bytes, msgs: bytes,
                       msg_len: int, count: int) -> None:
    _native_call(strobe, native.lib().merlin_append_msgs, label, len(label),
                 msgs, msg_len, count)


def native_challenges(strobe: "Strobe128", label: bytes, count: int) -> bytes:
    out = ctypes.create_string_buffer(32 * count)
    _native_call(strobe, native.lib().transcript_challenges, label, len(label),
                 out, count)
    return out.raw

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak.f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internals ---------------------------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak.f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        # chunked XOR into the rate portion of the state (whole-chunk int
        # XOR: ~10x the per-byte Python loop)
        i = 0
        n = len(data)
        while i < n:
            take = min(STROBE_R - self.pos, n - i)
            p = self.pos
            x = int.from_bytes(self.state[p:p + take], "little") ^ \
                int.from_bytes(data[i:i + take], "little")
            self.state[p:p + take] = x.to_bytes(take, "little")
            self.pos += take
            i += take
            if self.pos == STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes) -> None:
        i = 0
        n = len(data)
        while i < n:
            take = min(STROBE_R - self.pos, n - i)
            self.state[self.pos: self.pos + take] = data[i: i + take]
            self.pos += take
            i += take
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            take = min(STROBE_R - self.pos, n - len(out))
            out += self.state[self.pos: self.pos + take]
            self.state[self.pos: self.pos + take] = bytes(take)
            self.pos += take
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError(
                    f"STROBE op continuation changed flags: {flags} != {self.cur_flags}")
            return
        if flags & FLAG_T:
            raise ValueError("STROBE transport ops not supported")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = (flags & (FLAG_C | FLAG_K)) != 0
        if force_f and self.pos != 0:
            self._run_f()

    # -- public ops --------------------------------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)
