"""Keccak-f[1600] permutation.

Host-side primitive backing the STROBE-128 / Merlin Fiat-Shamir transcript
(the counterpart of the Go reference's `jsign/merlin` dependency,
transcript/transcript.go:8). The port's own copy of
go_curdleproofs_tpu/utils/keccak.py.

Two implementations:
  * the host C library's (go_curdleproofs_tpu_torch/native/keccak.c through
    utils/native.py): a full shuffle proof absorbs ~150 KB into the
    transcript;
  * pure Python, used when there is no host library.

The permutation operates on a 200-byte state (25 little-endian 64-bit lanes).
"""

from __future__ import annotations

import ctypes

from . import native

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

# Rotation offsets r[x][y] for lane A[x, y] (flat index x + 5*y).
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def _f1600_py(lanes: list[int]) -> list[int]:
    """One Keccak-f[1600] permutation over 25 lanes, A[x + 5*y]."""
    a = list(lanes)
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK)
        # iota
        a[0] ^= rc
    return a


def f1600_py(state: bytearray) -> None:
    """In-place permutation of a 200-byte state (pure Python)."""
    lanes = [int.from_bytes(state[8 * i: 8 * i + 8], "little") for i in range(25)]
    lanes = _f1600_py(lanes)
    for i in range(25):
        state[8 * i: 8 * i + 8] = lanes[i].to_bytes(8, "little")


def f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state; native if available."""
    nat = native.lib()
    if nat is not None:
        nat.keccak_f1600((ctypes.c_char * 200).from_buffer(state))
    else:
        f1600_py(state)


def has_native() -> bool:
    return native.lib() is not None


# ---------------------------------------------------------------------------
# Minimal sponge (used only for self-tests validating f1600 against hashlib).

def _sponge(data: bytes, rate: int, pad_byte: int, outlen: int) -> bytes:
    st = bytearray(200)
    # absorb
    pos = 0
    for byt in data:
        st[pos] ^= byt
        pos += 1
        if pos == rate:
            f1600(st)
            pos = 0
    st[pos] ^= pad_byte
    st[rate - 1] ^= 0x80
    f1600(st)
    # squeeze
    out = bytearray()
    while len(out) < outlen:
        out += st[:rate]
        if len(out) < outlen:
            f1600(st)
    return bytes(out[:outlen])


def sha3_256(data: bytes) -> bytes:
    return _sponge(data, 136, 0x06, 32)


def shake_256(data: bytes, outlen: int) -> bytes:
    return _sponge(data, 136, 0x1F, outlen)
