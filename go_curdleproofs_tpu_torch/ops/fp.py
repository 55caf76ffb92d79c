"""BLS12-381 base field Fp as exact integer tensors.

An element is a `[..., 12]` `torch.int32` tensor holding the little-endian
32-bit words (uint32 bit patterns) of its Montgomery form x*R mod p with
R = 2^384, always fully reduced below p. The CUDA kernels
(ops/csrc/fp.cuh) compute in exactly this form; the plain ops here are the
same arithmetic written as torch integer ops, so they run on any device.

`mul` (and what is built on it: `square`, `mul_small`, `from_mont`) and the
fixed-exponent ladders `inv` and `sqrt_candidate` go through the kernel
wrappers of ops/kernels.py: a CUDA tensor launches the `mont_mul` /
`pow_fixed` kernel, a CPU tensor runs `mul_plain` / `pow_fixed_plain`. The
`*_plain` functions never reach a kernel on any device: the kernels are held
against them. add, sub, neg and the comparisons have no kernel of their own
(the TPU package left them to XLA) and are plain torch ops everywhere.

torch has no usable uint64 arithmetic, so the plain ops split each word into
two 16-bit half-limbs held in int64: a limb product is < 2^32 and a 24-term
column sum < 2^37. Carries resolve without a sequential loop: a few rounds
of "keep 16 bits, pass the rest up" bring every column under 2^17, then one
prefix scan (cummax over the positions that stop a carry chain) settles the
remaining 0/1 carries exactly.

The only ways in and out are `from_ints` and `to_ints` (canonical Python
ints); nothing outside this module reads the words.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import List, Sequence

import numpy as np
import torch

from ..utils.field_host import P

NWORDS = 12                 # 32-bit words per element
NLIMBS = 24                 # 16-bit half-limbs per element (plain ops)
R_BITS = 384
R_MOD_P = (1 << R_BITS) % P
R_INV = pow(1 << R_BITS, -1, P)
MASK = 0xFFFF
DTYPE = torch.int32

_MAX_COL = 0x1FFFE          # column bound that `_resolve` accepts


def _limbs_of(v: int, n: int = NLIMBS) -> List[int]:
    return [(v >> (16 * i)) & MASK for i in range(n)]


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> SimpleNamespace:
    """Per-device constant limb vectors (built once per device)."""
    t = lambda vals: torch.tensor(vals, dtype=torch.int64, device=device)
    n = NLIMBS
    diag = [i + j for i in range(n) for j in range(n)]
    half_plus_one = (P - 1) // 2 + 1
    return SimpleNamespace(
        p=t(_limbs_of(P)),
        # -p^-1 mod R: Montgomery's m = (T mod R) * nprime mod R
        nprime=t(_limbs_of((-pow(P, -1, 1 << R_BITS)) % (1 << R_BITS))),
        r_minus_p=t(_limbs_of((1 << R_BITS) - P)),
        r_minus_half1=t(_limbs_of((1 << R_BITS) - half_plus_one)),
        diag=t(diag),                           # column of limb product (i, j)
        idx=t(list(range(2 * n + 1))),
        e0=t([1] + [0] * (n - 1)),
    )


# -- half-limb form ----------------------------------------------------------

def _split(x: torch.Tensor) -> torch.Tensor:
    """[..., 12] int32 words -> [..., 24] int64 16-bit limbs."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([v & MASK, v >> 16], dim=-1).flatten(-2)


def _join(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 24] int64 16-bit limbs -> [..., 12] int32 words."""
    v = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    return (v - ((v >> 31) << 32)).to(DTYPE)


def _carry_rounds(c: torch.Tensor, bound: int) -> torch.Tensor:
    """Columns <= bound -> columns <= _MAX_COL with the same value mod
    2^(16 * width) (a carry out of the top column is dropped)."""
    while bound > _MAX_COL:
        hi = c >> 16
        c = (c & MASK) + torch.nn.functional.pad(hi[..., :-1], (1, 0))
        bound = MASK + (bound >> 16)
    return c


def _resolve(c: torch.Tensor):
    """Exact carry propagation for columns <= _MAX_COL (column 0 may be one
    more). Returns (16-bit limbs, carry out of the top column).

    Every column carries 0 or 1 out. A column "stops" a chain when its
    carry-out does not depend on its carry-in (it generates, or it is not
    all ones); the carry into column i is the generate bit of the last stop
    below i, found with one cummax."""
    n = c.shape[-1]
    k = _consts(c.device)
    g = c >> 16
    lo = c & MASK
    stop = (g != 0) | (lo != MASK)
    last = torch.where(stop, k.idx[:n], -1).cummax(dim=-1).values
    prev = torch.nn.functional.pad(last, (1, 0), value=-1)      # [..., n+1]
    g0 = torch.nn.functional.pad(g, (1, 0))                     # g0[0] = 0
    cin = torch.gather(g0, -1, prev + 1)
    return (lo + cin[..., :n]) & MASK, cin[..., n]


def _cond_sub_p(s: torch.Tensor) -> torch.Tensor:
    """Limbs of a value < 2p -> limbs of the value mod p."""
    t, ge = _resolve(s + _consts(s.device).r_minus_p)
    return torch.where(ge.bool()[..., None], t, s)


def _add_l(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s, _ = _resolve(a + b)
    return _cond_sub_p(s)


def _neg_l(a: torch.Tensor) -> torch.Tensor:
    k = _consts(a.device)
    d, _ = _resolve(k.p + (MASK - a) + k.e0)          # p - a
    return torch.where((a == 0).all(-1, keepdim=True), a, d)


def _product_cols(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """Column sums of the limb product a*b (columns 0..width-1)."""
    o = a[..., :, None] * b[..., None, :]                       # [..., 24, 24]
    k = _consts(o.device)
    out = torch.zeros(o.shape[:-2] + (2 * NLIMBS,), dtype=torch.int64,
                      device=o.device)
    out.scatter_add_(-1, k.diag.expand(o.shape[:-2] + (NLIMBS * NLIMBS,)),
                     o.flatten(-2))
    return out[..., :width]


def _mont_l(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a*b/R mod p on half-limbs (inputs < p)."""
    k = _consts(a.device)
    col = NLIMBS * MASK * MASK
    t = _product_cols(a, b, 2 * NLIMBS)                         # < 2^37
    # m = (T mod R) * nprime mod R, from T's unnormalised low columns
    m = _product_cols(t[..., :NLIMBS], k.nprime, NLIMBS)        # < 2^58
    m, _ = _resolve(_carry_rounds(m, col * NLIMBS * MASK))
    u = _product_cols(m, k.p, 2 * NLIMBS)                       # < 2^37
    s, _ = _resolve(_carry_rounds(t + u, 2 * col))
    # T + m*p is a multiple of R and (T + m*p)/R < 2p
    return _cond_sub_p(s[..., NLIMBS:])


# -- public API ---------------------------------------------------------------

def from_ints(vals: Sequence[int], device: torch.device) -> torch.Tensor:
    """Python ints -> [n, 12] Montgomery-form elements on `device`."""
    buf = b"".join((int(v) % P * R_MOD_P % P).to_bytes(48, "little")
                   for v in vals)
    arr = np.frombuffer(buf, dtype="<u4").reshape(len(vals), NWORDS)
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_ints(x: torch.Tensor) -> List[int]:
    """[..., 12] elements -> canonical Python ints (leaves Montgomery form),
    flattened over the batch dims."""
    raw = x.reshape(-1, NWORDS).cpu().numpy().view("<u4").tobytes()
    return [int.from_bytes(raw[48 * i:48 * (i + 1)], "little") * R_INV % P
            for i in range(len(raw) // 48)]


@functools.lru_cache(maxsize=None)
def _row(v: int, device: torch.device) -> torch.Tensor:
    return from_ints([v], device)[0]


def constant(v: int, shape=(), *, device: torch.device) -> torch.Tensor:
    """The element v broadcast to `shape` (a materialised copy)."""
    return _row(int(v) % P, device).expand(tuple(shape) + (NWORDS,)).clone()


def zeros(shape=(), *, device: torch.device) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (NWORDS,), dtype=DTYPE, device=device)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _join(_add_l(_split(a), _split(b)))


def neg(a: torch.Tensor) -> torch.Tensor:
    return _join(_neg_l(_split(a)))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _join(_add_l(_split(a), _neg_l(_split(b))))


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product in torch integer ops, on any device (shapes
    broadcast)."""
    return _join(_mont_l(_split(a), _split(b)))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product through the `mont_mul` kernel wrapper. Operands
    are contiguous and of one shape, or either is a single [12] element."""
    from . import kernels
    return kernels.mont_mul(a, b)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_small_plain(a: torch.Tensor, c: int) -> torch.Tensor:
    return mul_plain(a, _row(c, a.device))


def mul_small(a: torch.Tensor, c: int) -> torch.Tensor:
    """a times the integer c (not c in Montgomery form): one Montgomery
    product with the element c."""
    return mul(a, _row(c, a.device))


def pow_fixed_plain(a: torch.Tensor, exponent: int) -> torch.Tensor:
    """a^exponent by MSB-first square-and-multiply (exponent >= 1), in
    plain products on any device."""
    if exponent < 1:
        raise ValueError("pow_fixed needs an exponent >= 1")
    acc = a
    for bit in bin(exponent)[3:]:
        acc = mul_plain(acc, acc)
        if bit == "1":
            acc = mul_plain(acc, a)
    return acc


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2) through the `pow_fixed` kernel wrapper;
    0 -> 0."""
    from . import kernels
    return kernels.pow_fixed(a, P - 2)


def sqrt_candidate(a: torch.Tensor) -> torch.Tensor:
    """a^((p+1)/4): a square root of a whenever one exists (p = 3 mod 4)."""
    from . import kernels
    return kernels.pow_fixed(a, (P + 1) // 4)


@functools.lru_cache(maxsize=None)
def _one_plain(device: torch.device) -> torch.Tensor:
    """The integer 1 as raw words (not in Montgomery form)."""
    one = torch.zeros(NWORDS, dtype=DTYPE, device=device)
    one[0] = 1
    return one


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """[..., 12] elements -> the little-endian words of their canonical
    values: one Montgomery product with the plain integer 1."""
    return mul(a, _one_plain(a.device))


def canonical_bytes_be(a: torch.Tensor) -> torch.Tensor:
    """[..., 12] elements -> [..., 48] uint8: the canonical value
    big-endian, as the wire format writes a coordinate."""
    w = from_mont(a).flip(-1).to(torch.int64) & 0xFFFFFFFF
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64, device=a.device)
    return ((w[..., None] >> shifts) & 0xFF).flatten(-2).to(torch.uint8)


def where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], a, b)


def stack(xs: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    if axis < 0:
        axis -= 1                    # count from before the word axis
    return torch.stack(list(xs), dim=axis)


def concat(xs: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    if axis < 0:
        axis -= 1
    return torch.cat(list(xs), dim=axis)


# -- canonical-value tests (the decoder's checks) -----------------------------

def is_zero(a: torch.Tensor) -> torch.Tensor:
    """[...] bool: a == 0 (elements are fully reduced, so by words)."""
    return (a == 0).all(-1)


def lex_gt_half(a: torch.Tensor) -> torch.Tensor:
    """[...] bool: canonical value of a > (p-1)/2 (gnark's
    LexicographicallyLargest; a tie is not largest)."""
    k = _consts(a.device)
    _, ge = _resolve(_split(from_mont(a)) + k.r_minus_half1)
    return ge.bool()                             # value >= (p-1)/2 + 1
