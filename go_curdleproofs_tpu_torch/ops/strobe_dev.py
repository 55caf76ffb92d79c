"""STROBE-128 / Merlin / the curdleproofs transcript on the device
(counterpart of go_curdleproofs_tpu/ops/strobe_dev.py's static-position
engine), so that the device-resident prover never waits for the host
mid-proof. Byte-exact with utils/strobe.py + utils/merlin.py +
utils/transcript.py.

Every absorb in the protocol has a static length and every challenge ends
at a position that depends on its label alone, so the STROBE position and
pos_begin at every point of the prover are host integers: `TState` carries
them beside the [200] uint8 state tensor. The layout arithmetic
(`_bulk_layout`, `_sim_msgs_pos`, `post_challenge_pos`) is host Python; the
bytes move through the two transcript kernels of ops/kernels.py:
`strobe_absorb_stream` takes the prepared byte stream of any number of
messages under one label (the traced row bytes are scattered into the
static template with one index op), `strobe_challenge32` squeezes,
rejection-samples against r and re-absorbs a challenge in one launch.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

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


@functools.lru_cache(maxsize=256)
def _rows_layout(pos: int, pb: int, label: bytes, k: int, L: int,
                 device: torch.device):
    """`_bulk_layout` with its arrays on `device` (uploaded once per
    layout and device)."""
    template, tr_pos, pbs, pos1, pb1 = _bulk_layout(pos, pb, label, k, L)
    return (bytes_tensor(template, device),
            halflimb.upload(tr_pos, torch.long, device),
            bytes_tensor(pbs, device), pos1, pb1)


@functools.lru_cache(maxsize=256)
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
        """A challenge below r ([32] uint8 big-endian), absorbed back into
        the transcript; rejected attempts are resampled on the device."""
        self.st, chal = kernels.strobe_challenge32(
            self.st, bytes(label), self.pos, self.pos_begin)
        self.pos, self.pos_begin = post_challenge_pos(label)
        return chal
