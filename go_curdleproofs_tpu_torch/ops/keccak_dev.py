"""Keccak-f[1600] in torch ops on a 200-byte state tensor (counterpart of
go_curdleproofs_tpu/ops/keccak_dev.py).

This is the plain version of the permutation inside the transcript kernels
(ops/csrc/transcript.cu): the CPU path and the reference that the kernels
are held against on the card. The 25 lanes are int64 bit patterns (lane
x + 5y, little-endian bytes); a rotation is two shifts, the right one made
logical by clearing the sign bit first. About 25 small ops a round.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

from . import halflimb

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

_ROT = [                      # r[x][y] for lane x + 5*y
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MAX63 = (1 << 63) - 1


def _signed(v: int) -> int:
    return v - (1 << 64) if v >> 63 else v


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> SimpleNamespace:
    # pi: B[y + 5*((2x+3y)%5)] = rotl(A[x+5y], r[x][y])
    src, rot = [0] * 25, [0] * 25
    for x in range(5):
        for y in range(5):
            dst = y + 5 * ((2 * x + 3 * y) % 5)
            src[dst] = x + 5 * y
            rot[dst] = _ROT[x][y]
    t = lambda vals: halflimb.upload(vals, torch.int64, device)
    rc = [[_signed(v)] + [0] * 24 for v in _RC]
    return SimpleNamespace(pi_src=t(src), pi_rot=t(rot), rc=t(rc))


def _rotl(x: torch.Tensor, n) -> torch.Tensor:
    """64-bit rotate left by n in [0, 63] (int or per-lane tensor)."""
    return (x << n) | (((x >> 1) & _MAX63) >> (63 - n))


def f1600(state: torch.Tensor) -> torch.Tensor:
    """One permutation of a [..., 200] uint8 state; returns a new tensor."""
    k = _consts(state.device)
    lead = state.shape[:-1]
    a = state.contiguous().view(torch.int64).reshape(lead + (5, 5))  # [y, x]
    for rnd in range(24):
        # theta: d[x] = c[x-1] ^ rotl(c[x+1], 1)
        c = a[..., 0, :] ^ a[..., 1, :] ^ a[..., 2, :] ^ a[..., 3, :] \
            ^ a[..., 4, :]
        d = c.roll(1, -1) ^ _rotl(c.roll(-1, -1), 1)
        a = a ^ d[..., None, :]
        # rho and pi: one gather, one per-lane rotation
        b = _rotl(a.flatten(-2).index_select(-1, k.pi_src), k.pi_rot)
        b = b.reshape(lead + (5, 5))
        # chi along x, iota on lane 0
        a = b ^ (~b.roll(-1, -1) & b.roll(-2, -1))
        a = a ^ k.rc[rnd].reshape(5, 5)
    return a.reshape(lead + (25,)).view(torch.uint8)
