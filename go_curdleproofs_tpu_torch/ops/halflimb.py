"""Exact multi-word integer arithmetic as torch ops, shared by the base
field (ops/fp.py), the scalar field (ops/fr.py) and the GLV split
(ops/glv_dev.py).

A value is a `[..., nwords]` `torch.int32` tensor of little-endian 32-bit
words (uint32 bit patterns). torch has no usable uint64 arithmetic, so the
ops split each word into two 16-bit half-limbs held in int64: a limb
product is < 2^32 and a column sum of a few dozen of them far below 2^63.
Carries resolve without a sequential loop: a few rounds of "keep 16 bits,
pass the rest up" bring every column under 2^17, then one prefix scan
(cummax over the positions that stop a carry chain) settles the remaining
0/1 carries exactly.

`Field` is Montgomery arithmetic modulo an odd modulus on that machinery:
an element is the word tensor of x*R mod m, R = 2^(32*nwords), always
fully reduced. The CUDA kernels (ops/csrc/fp.cuh, fr.cuh) compute in
exactly this form.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import List, Sequence

import numpy as np
import torch

from ..utils import profiling

MASK = 0xFFFF
DTYPE = torch.int32

_MAX_COL = 0x1FFFE          # column bound that `resolve` accepts


def upload(vals, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host values (a list or a numpy array) -> a tensor on `device`. The
    copy does not wait for the device, so an upload in the middle of a
    chain of device work leaves the chain asynchronous."""
    host = torch.as_tensor(vals, dtype=dtype)
    return host.to(device, non_blocking=True)


def limbs_of(v: int, n: int) -> List[int]:
    return [(v >> (16 * i)) & MASK for i in range(n)]


@functools.lru_cache(maxsize=None)
def const_limbs(v: int, n: int, device: torch.device) -> torch.Tensor:
    """The n 16-bit limbs of the integer v as an int64 tensor on `device`
    (uploaded once per value and device)."""
    return upload(limbs_of(v, n), torch.int64, device)


@functools.lru_cache(maxsize=None)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _diag(na: int, nb: int, device: torch.device) -> torch.Tensor:
    """Column of limb product (i, j), flattened."""
    return upload([i + j for i in range(na) for j in range(nb)],
                  torch.int64, device)


def split(x: torch.Tensor) -> torch.Tensor:
    """[..., n] int32 words -> [..., 2n] int64 16-bit limbs."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & MASK, v >> 16], dim=-1).flatten(-2)


def join(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 2n] int64 16-bit limbs -> [..., n] int32 words."""
    v = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    return (v - ((v >> 31) << 32)).to(DTYPE)


def carry_rounds(c: torch.Tensor, bound: int) -> torch.Tensor:
    """Columns <= bound -> columns <= _MAX_COL with the same value mod
    2^(16 * width) (a carry out of the top column is dropped)."""
    while bound > _MAX_COL:
        hi = c >> 16
        c = (c & MASK) + torch.nn.functional.pad(hi[..., :-1], (1, 0))
        bound = MASK + (bound >> 16)
    return c


def resolve(c: torch.Tensor):
    """Exact carry propagation for columns <= _MAX_COL (column 0 may be one
    more). Returns (16-bit limbs, carry out of the top column).

    Every column carries 0 or 1 out. A column "stops" a chain when its
    carry-out does not depend on its carry-in (it generates, or it is not
    all ones); the carry into column i is the generate bit of the last stop
    below i, found with one cummax."""
    n = c.shape[-1]
    g = c >> 16
    lo = c & MASK
    stop = (g != 0) | (lo != MASK)
    last = torch.where(stop, _arange(n, c.device), -1).cummax(dim=-1).values
    prev = torch.nn.functional.pad(last, (1, 0), value=-1)      # [..., n+1]
    g0 = torch.nn.functional.pad(g, (1, 0))                     # g0[0] = 0
    cin = torch.gather(g0, -1, prev + 1)
    return (lo + cin[..., :n]) & MASK, cin[..., n]


def product_cols(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Column sums of the limb product a*b (columns 0..width-1); a is
    [..., na], b is [..., nb] (batch shapes broadcast)."""
    na, nb = a.shape[-1], b.shape[-1]
    o = a[..., :, None] * b[..., None, :]                       # [..., na, nb]
    out = torch.zeros(o.shape[:-2] + (na + nb,), dtype=torch.int64,
                      device=o.device)
    out.scatter_add_(-1, _diag(na, nb, o.device).expand(
        o.shape[:-2] + (na * nb,)), o.flatten(-2))
    return out[..., :width]


def sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a - b mod 2^(16 n), a >= b) for 16-bit limb tensors of width n."""
    n = a.shape[-1]
    one = const_limbs(1, n, a.device)
    d, carry = resolve(a + (MASK - b) + one)
    return d, carry.bool()


def words_to_bytes_be(w: torch.Tensor) -> torch.Tensor:
    """[..., n] little-endian words -> [..., 4n] uint8, big-endian."""
    v = w.flip(-1).to(torch.int64) & 0xFFFFFFFF
    shifts = 8 * _arange(4, w.device).flip(0)
    return ((v[..., None] >> shifts) & 0xFF).flatten(-2).to(torch.uint8)


def bytes_be_to_words(b: torch.Tensor) -> torch.Tensor:
    """[..., 4n] uint8 big-endian -> [..., n] little-endian int32 words."""
    v = b.to(torch.int64).unflatten(-1, (-1, 4))
    shifts = 8 * _arange(4, b.device).flip(0)
    v = (v << shifts).sum(-1).flip(-1)
    return (v - ((v >> 31) << 32)).to(DTYPE)


class Field:
    """Montgomery arithmetic modulo the odd `modulus` on `nwords` words."""

    def __init__(self, modulus: int, nwords: int):
        self.modulus = modulus
        self.nwords = nwords
        self.nlimbs = 2 * nwords
        self.r_bits = 32 * nwords
        self.r_mod = (1 << self.r_bits) % modulus
        self.r_inv = pow(1 << self.r_bits, -1, modulus)
        self.consts = functools.lru_cache(maxsize=None)(self._build_consts)
        self.row = functools.lru_cache(maxsize=None)(self._build_row)
        self.one_plain = functools.lru_cache(maxsize=None)(
            self._build_one_plain)

    def _build_consts(self, device: torch.device) -> SimpleNamespace:
        """Per-device constant limb vectors (built once per device)."""
        m, n, big = self.modulus, self.nlimbs, 1 << self.r_bits
        return SimpleNamespace(
            p=const_limbs(m, n, device),
            # -m^-1 mod R: Montgomery's q = (T mod R) * nprime mod R
            nprime=const_limbs((-pow(m, -1, big)) % big, n, device),
            r_minus_p=const_limbs(big - m, n, device),
            e0=const_limbs(1, n, device))

    def _build_row(self, v: int, device: torch.device) -> torch.Tensor:
        return self.from_ints([v], device)[0]

    def _build_one_plain(self, device: torch.device) -> torch.Tensor:
        """The integer 1 as raw words (not in Montgomery form)."""
        return upload([1] + [0] * (self.nwords - 1), DTYPE, device)

    # -- half-limb form ------------------------------------------------------

    def cond_sub(self, s: torch.Tensor) -> torch.Tensor:
        """Limbs of a value < 2m -> limbs of the value mod m."""
        t, ge = resolve(s + self.consts(s.device).r_minus_p)
        return torch.where(ge.bool()[..., None], t, s)

    def add_l(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s, _ = resolve(a + b)
        return self.cond_sub(s)

    def neg_l(self, a: torch.Tensor) -> torch.Tensor:
        k = self.consts(a.device)
        d, _ = resolve(k.p + (MASK - a) + k.e0)          # m - a
        return torch.where((a == 0).all(-1, keepdim=True), a, d)

    def mont_l(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b/R mod m on half-limbs (inputs < m)."""
        k = self.consts(a.device)
        n = self.nlimbs
        col = n * MASK * MASK
        t = product_cols(a, b, 2 * n)
        # q = (T mod R) * nprime mod R, from T's unnormalised low columns
        q = product_cols(t[..., :n], k.nprime, n)
        q, _ = resolve(carry_rounds(q, col * n * MASK))
        u = product_cols(q, k.p, 2 * n)
        s, _ = resolve(carry_rounds(t + u, 2 * col))
        # T + q*m is a multiple of R and (T + q*m)/R < 2m
        return self.cond_sub(s[..., n:])

    # -- elements -------------------------------------------------------------

    def from_ints(self, vals: Sequence[int],
                  device: torch.device) -> torch.Tensor:
        """Python ints -> [n, nwords] Montgomery-form elements on `device`."""
        nbytes = 4 * self.nwords
        buf = b"".join((int(v) % self.modulus * self.r_mod
                        % self.modulus).to_bytes(nbytes, "little")
                       for v in vals)
        arr = np.frombuffer(buf, dtype="<u4").reshape(len(vals), self.nwords)
        return upload(arr.view(np.int32).copy(), DTYPE, device)

    def to_ints(self, x: torch.Tensor) -> List[int]:
        """[..., nwords] elements -> canonical Python ints (leaves
        Montgomery form), flattened over the batch dims: a `fetch` span
        around the blocking copy, a `convert` span around the host's
        conversion."""
        nbytes = 4 * self.nwords
        flat = x.reshape(-1, self.nwords)
        with profiling.span("fetch"):
            host = flat.cpu()
        with profiling.span("convert"):
            raw = host.numpy().view("<u4").tobytes()
            return [int.from_bytes(raw[nbytes * i:nbytes * (i + 1)], "little")
                    * self.r_inv % self.modulus
                    for i in range(len(raw) // nbytes)]

    def constant(self, v: int, shape=(), *,
                 device: torch.device) -> torch.Tensor:
        """The element v broadcast to `shape` (a materialised copy)."""
        return self.row(int(v) % self.modulus, device).expand(
            tuple(shape) + (self.nwords,)).clone()

    def zeros(self, shape=(), *, device: torch.device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (self.nwords,), dtype=DTYPE,
                           device=device)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return join(self.add_l(split(a), split(b)))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return join(self.neg_l(split(a)))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return join(self.add_l(split(a), self.neg_l(split(b))))

    def mul_plain(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product in torch integer ops, on any device (shapes
        broadcast)."""
        return join(self.mont_l(split(a), split(b)))

    def pow_fixed_plain(self, a: torch.Tensor, exponent: int) -> torch.Tensor:
        """a^exponent by MSB-first square-and-multiply (exponent >= 1), in
        plain products on any device."""
        if exponent < 1:
            raise ValueError("pow_fixed needs an exponent >= 1")
        acc = a
        for bit in bin(exponent)[3:]:
            acc = self.mul_plain(acc, acc)
            if bit == "1":
                acc = self.mul_plain(acc, a)
        return acc
