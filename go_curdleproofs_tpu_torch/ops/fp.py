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

The plain arithmetic (16-bit half-limbs in int64, loop-free carries) is
ops/halflimb.py's `Field`, shared with the scalar field (ops/fr.py).

The only ways in and out are `from_ints` and `to_ints` (canonical Python
ints); nothing outside this module reads the words.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils.field_host import P
from . import halflimb

NWORDS = 12                 # 32-bit words per element
R_BITS = 384
DTYPE = halflimb.DTYPE

_F = halflimb.Field(P, NWORDS)

from_ints = _F.from_ints
to_ints = _F.to_ints
constant = _F.constant
zeros = _F.zeros
add = _F.add
neg = _F.neg
sub = _F.sub
mul_plain = _F.mul_plain
pow_fixed_plain = _F.pow_fixed_plain


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product through the `mont_mul` kernel wrapper. Operands
    are contiguous and of one shape, or either is a single [12] element."""
    from . import kernels
    return kernels.mont_mul(a, b)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_small_plain(a: torch.Tensor, c: int) -> torch.Tensor:
    return mul_plain(a, _F.row(c, a.device))


def mul_small(a: torch.Tensor, c: int) -> torch.Tensor:
    """a times the integer c (not c in Montgomery form): one Montgomery
    product with the element c."""
    return mul(a, _F.row(c, a.device))


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2) through the `pow_fixed` kernel wrapper;
    0 -> 0."""
    from . import kernels
    return kernels.pow_fixed(a, P - 2)


def sqrt_candidate(a: torch.Tensor) -> torch.Tensor:
    """a^((p+1)/4): a square root of a whenever one exists (p = 3 mod 4)."""
    from . import kernels
    return kernels.pow_fixed(a, (P + 1) // 4)


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """[..., 12] elements -> the little-endian words of their canonical
    values: one Montgomery product with the plain integer 1."""
    return mul(a, _F.one_plain(a.device))


def canonical_bytes_be(a: torch.Tensor) -> torch.Tensor:
    """[..., 12] elements -> [..., 48] uint8: the canonical value
    big-endian, as the wire format writes a coordinate."""
    return halflimb.words_to_bytes_be(from_mont(a))


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
    half1 = halflimb.const_limbs((1 << R_BITS) - ((P - 1) // 2 + 1),
                                 _F.nlimbs, a.device)
    _, ge = halflimb.resolve(halflimb.split(from_mont(a)) + half1)
    return ge.bool()                             # value >= (p-1)/2 + 1
