"""STROBE-128 / Merlin / the curdleproofs transcript on the device
(counterpart of go_curdleproofs_tpu/ops/strobe_dev.py), so that the
device-resident prover never waits for the host mid-proof. Byte-exact
with utils/strobe.py + utils/merlin.py + utils/transcript.py.

Two engines. The functional one (`SState` and the functions after it:
`absorb`, `squeeze`, `meta_ad`, `ad`, `prf`, `append_message`,
`challenge_bytes`, `get_and_append_challenge`) works from any position,
one operation at a time, and never writes into its input: each call
returns a new `SState`. Its positions are host ints, since every length
is known on the host; every Keccak-f[1600] runs in the two transcript
kernels (`strobe_absorb_stream` for absorbs, squeezes and the forced
permutation of a PRF, `strobe_challenge32` for a challenge).

The prover's engine, `TState`: every absorb in the protocol has a static
length and every challenge ends at a position that depends on its label
alone, so the STROBE position and pos_begin at every point of the prover
are host integers: `TState` carries them beside the [200] uint8 state
tensor. The layout arithmetic
(`_bulk_layout`, `_sim_msgs_pos`, `post_challenge_pos`) is host Python; the
bytes move through the two transcript kernels of ops/kernels.py:
`strobe_absorb_stream` takes the prepared byte stream of any number of
messages under one label (the traced row bytes are scattered into the
static template with one index op), `strobe_challenge32` squeezes,
rejection-samples against r and re-absorbs a challenge in one launch.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import strobe as strobe_host
from . import halflimb, kernels

STROBE_R = kernels.STROBE_R
FLAG_I, FLAG_A, FLAG_C, FLAG_M = (kernels.FLAG_I, kernels.FLAG_A,
                                  kernels.FLAG_C, kernels.FLAG_M)


def _u32le(n: int) -> bytes:
    return int(n).to_bytes(4, "little")


def _bulk_layout(pos0: int, pb0: int, label: bytes, k: int, L: int,
                 const_rows=None):
    """Static layout of k Merlin messages of L bytes under one label:
    returns (template [N] int32, stream positions of the message bytes
    [k*L], pos_begin at each rate crossing, final pos, final pos_begin).
    With const_rows, the row bytes are baked into the template instead (no
    message positions)."""
    template: List[int] = []
    tr_pos: List[int] = []
    pbs: List[int] = []
    pos, pb = pos0, pb0

    def emit(b):
        nonlocal pos, pb
        template.append(int(b))
        pos += 1
        if pos == STROBE_R:
            pbs.append(pb)
            pos = pb = 0

    for r in range(k):
        old, pb = pb, pos + 1               # meta-AD(label)
        emit(old)
        emit(FLAG_M | FLAG_A)
        for b in label + _u32le(L):         # ... meta-AD(u32le(L), more)
            emit(b)
        old, pb = pb, pos + 1               # AD(message)
        emit(old)
        emit(FLAG_A)
        for c in range(L):
            if const_rows is None:
                tr_pos.append(len(template))
                emit(0)
            else:
                emit(int(const_rows[r][c]))
    return (np.asarray(template, np.int32), np.asarray(tr_pos, np.int32),
            pbs, pos, pb)


def _challenge_prefix(pos0: int, pb0: int, label: bytes):
    """The bytes a 32-byte challenge absorbs before its forced permutation
    (meta-AD(label), meta-AD(u32le(32)), the begin of the PRF operation):
    (bytes, pos_begin at each rate crossing, final pos, final pos_begin)."""
    out = bytearray()
    pbs: List[int] = []
    pos, pb = pos0, pb0

    def emit(b):
        nonlocal pos, pb
        out.append(b)
        pos += 1
        if pos == STROBE_R:
            pbs.append(pb)
            pos = pb = 0

    old, pb = pb, pos + 1
    emit(old)
    emit(FLAG_M | FLAG_A)
    for b in label + _u32le(32):
        emit(b)
    old, pb = pb, pos + 1
    emit(old)
    emit(FLAG_I | FLAG_A | FLAG_C)
    return bytes(out), pbs, pos, pb


def _sim_msgs_pos(pos: int, pb: int, msgs) -> Tuple[int, int]:
    """Advance (pos, pos_begin) across append_message calls [(label_len,
    msg_len), ...]: the host-side twin of the static layout."""
    def adv(n):
        nonlocal pos, pb
        while n:
            take = min(STROBE_R - pos, n)
            pos += take
            n -= take
            if pos == STROBE_R:
                pos, pb = 0, 0

    for (ll, ml) in msgs:
        pb = pos + 1
        adv(2 + ll + 4)
        pb = pos + 1
        adv(2 + ml)
    return pos, pb


def post_challenge_pos(label: bytes) -> Tuple[int, int]:
    """(pos, pos_begin) right after get_and_append_challenge(label): the
    squeeze always leaves pos 32 / pos_begin 0, then the accepted challenge
    is absorbed back: a static function of the label alone."""
    return _sim_msgs_pos(32, 0, [(len(label), 32)])


def bytes_tensor(data, device: torch.device) -> torch.Tensor:
    arr = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    return halflimb.upload(arr.copy(), torch.uint8, device)


@halflimb.device_cache(maxsize=1024)
def _const(data: bytes, device: torch.device) -> torch.Tensor:
    """Bytes that recur (operation headers, the pos_begin of each rate
    crossing) on `device`, uploaded once per value and device."""
    return bytes_tensor(data, device)


# -- the functional engine ------------------------------------------------------

class SState(NamedTuple):
    """A STROBE state on a device: st [200] uint8, pos and pos_begin host
    ints."""
    st: torch.Tensor
    pos: int
    pos_begin: int


def from_host(h: strobe_host.Strobe128, *, device: torch.device) -> SState:
    """A host Strobe128's state, uploaded."""
    return SState(bytes_tensor(bytes(h.state), device), h.pos, h.pos_begin)


def to_host(s: SState, template: Optional[strobe_host.Strobe128],
            cur_flags: int) -> strobe_host.Strobe128:
    """The device state as a host Strobe128 (one fetch); `template` is
    not read (the JAX package's signature)."""
    h = strobe_host.Strobe128.__new__(strobe_host.Strobe128)
    h.state = bytearray(s.st.cpu().numpy().tobytes())
    h.pos, h.pos_begin, h.cur_flags = s.pos, s.pos_begin, cur_flags
    return h


def _crossings(pos: int, pb: int, n: int) -> Tuple[bytes, int, int]:
    """Absorbing n bytes from (pos, pos_begin): the pos_begin of each rate
    crossing, then the (pos, pos_begin) after them."""
    pbs = bytearray()
    while pos + n >= STROBE_R:
        n -= STROBE_R - pos
        pbs.append(pb)
        pos = pb = 0
    return bytes(pbs), pos + n, pb


def _xor_in(s: SState, data: torch.Tensor, force_f: bool = False) -> SState:
    """`data` XORed into the rate from s.pos in one `strobe_absorb_stream`
    launch, permuting at each rate crossing; with force_f, once more at
    the end when the position is not 0 (a PRF's forced permutation)."""
    pbs, pos, pb = _crossings(s.pos, s.pos_begin, data.shape[0])
    st = kernels.strobe_absorb_stream(s.st, data, s.pos,
                                      _const(pbs, s.st.device),
                                      final_pb=pb if force_f else None)
    return SState(st, 0, 0) if force_f else SState(st, pos, pb)


def absorb(s: SState, data) -> SState:
    """XOR `data` ([k] uint8 tensor on the state's device, or host bytes)
    into the rate at pos."""
    if not isinstance(data, torch.Tensor):
        data = bytes_tensor(data, s.st.device)
    return _xor_in(s, data) if data.shape[0] else s


def squeeze(s: SState, k: int) -> Tuple[SState, torch.Tensor]:
    """Read k bytes of the rate from pos ([k] uint8); what is read is
    zeroed by XORing the same bytes back in (the absorb kernel, which
    permutes at each rate crossing)."""
    out = s.st[:0]
    while k > 0:
        take = min(STROBE_R - s.pos, k)
        out = torch.cat([out, s.st[s.pos:s.pos + take]])
        s = _xor_in(s, out[out.shape[0] - take:])
        k -= take
    return s, out


def _begin_op(s: SState, flags: int, force_f: bool) -> SState:
    header = _const(bytes([s.pos_begin, flags]), s.st.device)
    return _xor_in(SState(s.st, s.pos, s.pos + 1), header, force_f)


def meta_ad(s: SState, data, more: bool) -> SState:
    if not more:
        s = _begin_op(s, FLAG_M | FLAG_A, False)
    return absorb(s, data)


def ad(s: SState, data, more: bool) -> SState:
    if not more:
        s = _begin_op(s, FLAG_A, False)
    return absorb(s, data)


def prf(s: SState, k: int) -> Tuple[SState, torch.Tensor]:
    return squeeze(_begin_op(s, FLAG_I | FLAG_A | FLAG_C, True), k)


def append_message(s: SState, label: bytes, message) -> SState:
    """Merlin's append_message; message: [L] uint8 tensor on the state's
    device, or host bytes."""
    s = meta_ad(s, bytes(label), False)
    s = meta_ad(s, _u32le(len(message)), True)
    return ad(s, message, False)


def challenge_bytes(s: SState, label: bytes,
                    n: int) -> Tuple[SState, torch.Tensor]:
    s = meta_ad(s, bytes(label), False)
    s = meta_ad(s, _u32le(n), True)
    return prf(s, n)


def get_and_append_challenge(s: SState,
                             label: bytes) -> Tuple[SState, torch.Tensor]:
    """The transcript's rejection-sampled challenge below r, absorbed back
    (utils/transcript.py), under a label of any length: one
    `strobe_challenge32` launch, which decides on the device. Returns
    (state, challenge [32] uint8 big-endian)."""
    st, chal = kernels.strobe_challenge32(s.st, bytes(label), s.pos,
                                          s.pos_begin)
    return SState(st, *post_challenge_pos(label)), chal


# -- the prover's static-position engine ---------------------------------------

@halflimb.device_cache(maxsize=256)
def _rows_layout(pos: int, pb: int, label: bytes, k: int, L: int,
                 device: torch.device):
    """`_bulk_layout` with its arrays on `device` (uploaded once per
    layout and device)."""
    template, tr_pos, pbs, pos1, pb1 = _bulk_layout(pos, pb, label, k, L)
    return (bytes_tensor(template, device),
            halflimb.upload(tr_pos, torch.long, device),
            bytes_tensor(pbs, device), pos1, pb1)


@halflimb.device_cache(maxsize=256)
def _prefix_layout(pos: int, pb: int, label: bytes, device: torch.device):
    stream, pbs, pos1, pb1 = _challenge_prefix(pos, pb, label)
    return (bytes_tensor(stream, device), bytes_tensor(pbs, device),
            pos1, pb1)


class TState:
    """The transcript's STROBE state on a device: a [200] uint8 tensor and
    the static pos / pos_begin as host ints."""

    __slots__ = ("st", "pos", "pos_begin")

    def __init__(self, st: torch.Tensor, pos: int, pos_begin: int):
        self.st = st
        self.pos = int(pos)
        self.pos_begin = int(pos_begin)

    def append_message(self, label: bytes, message) -> None:
        """message: [L] uint8 tensor on the state's device, or host bytes."""
        if not isinstance(message, torch.Tensor):
            message = bytes_tensor(message, self.st.device)
        self.append_rows(label, message[None])

    def append_rows(self, label: bytes, rows) -> None:
        """Absorb k equal-length messages under one label in one launch.
        rows: [k, L] uint8 tensor on the state's device, or a host array
        of bytes, which is uploaded."""
        if not isinstance(rows, torch.Tensor):
            rows = bytes_tensor(rows, self.st.device)
        if rows.ndim == 1:
            rows = rows[None]
        k, L = rows.shape
        template, tr_pos, pbs, pos1, pb1 = _rows_layout(
            self.pos, self.pos_begin, bytes(label), k, L, self.st.device)
        flat = template.index_copy(0, tr_pos, rows.reshape(-1))
        self.st = kernels.strobe_absorb_stream(self.st, flat, self.pos, pbs)
        self.pos, self.pos_begin = pos1, pb1

    def challenge_bytes32(self, label: bytes) -> torch.Tensor:
        """One 32-byte challenge ([32] uint8), not yet tested against r."""
        stream, pbs, pos1, pb1 = _prefix_layout(
            self.pos, self.pos_begin, bytes(label), self.st.device)
        st = kernels.strobe_absorb_stream(self.st, stream, self.pos, pbs,
                                          final_pb=pb1)
        out = st[:32].clone()              # the forced permutation left pos 0
        st[:32].zero_()
        self.st, self.pos, self.pos_begin = st, 32, 0
        return out

    def get_and_append_challenge(self, label: bytes) -> torch.Tensor:
        """A challenge below r ([32] uint8 big-endian) under a label of
        any length, absorbed back into the transcript; rejected attempts
        are resampled on the device, in one launch."""
        self.st, chal = kernels.strobe_challenge32(
            self.st, bytes(label), self.pos, self.pos_begin)
        self.pos, self.pos_begin = post_challenge_pos(label)
        return chal
