"""Device-side GLV decomposition and signed-digit recode of scalar-field
elements (counterpart of go_curdleproofs_tpu/ops/glv_dev.py).

The device-resident prover computes MSM window digits on the device from
folded Fr vectors. This module lifts that computation to the GLV scheme of
ops/glv.py:

    s (canonical) -> (s1, s2) = (s mod LAMBDA, s div LAMBDA) by a Barrett
    division by the fixed 128-bit LAMBDA, then the bias-trick signed recode
    (nibbles of half + BIAS, minus 8) -> [2n, NUM_WINDOWS] interleaved
    signed digits.

All of it is exact integer work on 16-bit half-limbs in int64 with the
loop-free carries of ops/halflimb.py, equal digit for digit to the host
`glv.scalars_to_digits_glv`. `recode_words` starts from canonical words,
as the host MSMs upload their scalars: it is the plain version of the
`glv_recode` kernel.
"""

from __future__ import annotations

import torch

from . import fr, glv, halflimb

MU = (1 << 256) // glv.LAMBDA          # Barrett constant, 129 bits

_S_LIMBS = 16                          # a canonical scalar, 256 bits
_H_LIMBS = 9                           # a half, its bias and MU: < 2^144


def _correct(r_: torch.Tensor, q: torch.Tensor, k: int):
    """One Barrett correction: (r_ - k*LAMBDA, q + k, the lanes where
    r_ >= k*LAMBDA and the correction applies)."""
    dev = r_.device
    d, ge = halflimb.sub_limbs(
        r_, halflimb.const_limbs(k * glv.LAMBDA, _H_LIMBS, dev))
    qk, _ = halflimb.resolve(q + halflimb.const_limbs(k, _H_LIMBS, dev))
    return d, qk, ge[..., None]


def _recode(half: torch.Tensor) -> torch.Tensor:
    """[n, 9] limbs of a half below 2^128 -> [n, NUM_WINDOWS] signed
    digits, MSB window first."""
    dev = half.device
    v, _ = halflimb.resolve(
        half + halflimb.const_limbs(glv.BIAS, _H_LIMBS, dev))
    shifts = 4 * torch.arange(4, dtype=torch.int64, device=dev)
    nibs = ((v[..., None] >> shifts) & 15).flatten(-2)          # LSB first
    digs = nibs[..., :glv.SIG_WINDOWS].clone()
    digs[..., :32] -= 8
    return digs.flip(-1).to(torch.int32)


def glv_split_digits(x: torch.Tensor) -> torch.Tensor:
    """[n, 8] scalar-field elements -> [2n, NUM_WINDOWS] int32 interleaved
    signed GLV digits (row 2i = s1_i for the P lanes, 2i+1 = s2_i for the
    phi lanes), MSB window first."""
    return recode_words(fr.canonical(x))


def recode_words(words: torch.Tensor) -> torch.Tensor:
    """`glv_split_digits` of canonical values: [n, 8] int32 little-endian
    words of scalars below r -> [2n, NUM_WINDOWS] int32 digits. The plain
    version of the `glv_recode` kernel (ops/kernels.py)."""
    dev = words.device
    s = halflimb.split(words)                                   # [n, 16]

    # Barrett: q_hat = (s * MU) >> 256, at most 2 under the true quotient
    prod = halflimb.product_cols(
        s, halflimb.const_limbs(MU, _H_LIMBS, dev), _S_LIMBS + _H_LIMBS)
    prod, _ = halflimb.resolve(halflimb.carry_rounds(
        prod, _H_LIMBS * halflimb.MASK * halflimb.MASK))
    q = prod[..., _S_LIMBS:]                                    # [n, 9]

    # r_hat = s - q*LAMBDA: non-negative and below 3*LAMBDA < 2^130, so it
    # is exact modulo 2^144
    ql = halflimb.product_cols(
        q, halflimb.const_limbs(glv.LAMBDA, 8, dev), _H_LIMBS)
    ql, _ = halflimb.resolve(halflimb.carry_rounds(
        ql, 8 * halflimb.MASK * halflimb.MASK))
    r_, _ = halflimb.sub_limbs(s[..., :_H_LIMBS], ql)
    d1, q1, ge1 = _correct(r_, q, 1)
    d2, q2, ge2 = _correct(r_, q, 2)
    r_ = torch.where(ge2, d2, torch.where(ge1, d1, r_))
    q = torch.where(ge2, q2, torch.where(ge1, q1, q))

    inter = torch.stack([_recode(r_), _recode(q)], dim=-2)      # [n, 2, W]
    return inter.flatten(-3, -2).contiguous()
