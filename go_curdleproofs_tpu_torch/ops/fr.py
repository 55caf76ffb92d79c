"""BLS12-381 scalar field Fr as exact integer tensors (counterpart of
go_curdleproofs_tpu/ops/fr.py over ops/limb_field.py).

An element is a `[..., 8]` `torch.int32` tensor holding the little-endian
32-bit words of its Montgomery form x*R mod r with R = 2^256, always fully
reduced below r: one form, as ops/fp.py has for the base field and as the
CUDA kernels (ops/csrc/fr.cuh) compute. Host protocol code uses Python
ints; this module exists for the device-resident prover, where scalar
folds, inner products, prefix products and the blinder solve run on the
device between group operations.

`mul` goes through the `fr_mont_mul` kernel wrapper and `inv` through
`fr_pow_fixed` (ops/kernels.py): a CUDA tensor launches the kernel, a CPU
tensor runs the plain version. add, sub, neg and selects are plain torch
ops on every device (ops/halflimb.py). The contract with the rest of the
program is values (`from_ints`, `to_ints`, canonical bytes), never words.
"""

from __future__ import annotations

import torch

from ..utils.field_host import R
from . import halflimb

NWORDS = 8                  # 32-bit words per element
DTYPE = halflimb.DTYPE

_F = halflimb.Field(R, NWORDS)

from_ints = _F.from_ints
to_ints = _F.to_ints
constant = _F.constant
add = _F.add
neg = _F.neg
sub = _F.sub
mul_plain = _F.mul_plain
pow_fixed_plain = _F.pow_fixed_plain


def _as_operand(t: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """A one-element operand against a batch becomes the [8] element that
    the kernel broadcasts in place."""
    if t.numel() == NWORDS < other.numel():
        return t.reshape(NWORDS)
    return t


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product through the `fr_mont_mul` kernel wrapper.
    Operands are contiguous and of one shape, or either holds a single
    element, which multiplies the whole batch."""
    from . import kernels
    return kernels.fr_mont_mul(_as_operand(a, b), _as_operand(b, a))


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(r-2) through the `fr_pow_fixed` kernel wrapper;
    0 -> 0."""
    from . import kernels
    return kernels.fr_pow_fixed(a, R - 2)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """[...] bool: a == 0 (elements are fully reduced, so by words)."""
    return (a == 0).all(-1)


def canonical(a: torch.Tensor) -> torch.Tensor:
    """[..., 8] elements -> the little-endian words of their canonical
    values: one Montgomery product with the plain integer 1."""
    return mul(a, _F.one_plain(a.device))


def canonical_bytes_be(a: torch.Tensor) -> torch.Tensor:
    """[..., 8] elements -> [..., 32] uint8: the canonical value
    big-endian, as the transcript and the wire format write a scalar."""
    return halflimb.words_to_bytes_be(canonical(a))


def from_bytes_be(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8, a big-endian value below 2^256 -> its element
    (reduced mod r): one Montgomery product with R^2 (the words of the
    element R mod r)."""
    return mul(halflimb.bytes_be_to_words(b), _F.row(_F.r_mod, b.device))


def inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> over the lane axis: [..., n, 8] x [..., n, 8] -> [..., 8]:
    one product, then a halving tree of sums on half-limbs."""
    cur = halflimb.split(mul(a, b))
    n = cur.shape[-2]
    while n > 1:
        half = n // 2
        s = _F.add_l(cur[..., :half, :], cur[..., half:2 * half, :])
        if n % 2:
            s = torch.cat([s, cur[..., n - 1:, :]], dim=-2)
        cur = s
        n = cur.shape[-2]
    return halflimb.join(cur[..., 0, :])


def prefix_products(b: torch.Tensor) -> torch.Tensor:
    """cs[0] = 1, cs[i] = b[0] * ... * b[i-1] over [n, 8]: the
    grand-product partial products as a log-step scan of products."""
    n = b.shape[0]
    cur = torch.cat([constant(1, (1,), device=b.device), b[:-1]])
    d = 1
    while d < n:
        cur = torch.cat([cur[:d], mul(cur[d:].contiguous(),
                                      cur[:n - d].contiguous())])
        d *= 2
    return cur
