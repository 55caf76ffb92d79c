"""GLV endomorphism decomposition + signed-digit recoding for BLS12-381 G1.

Host numpy counterpart of gnark-crypto's GLV+wNAF `ScalarMultiplication`
(SURVEY.md section 2.2, G1 row; the port's own copy of
go_curdleproofs_tpu/ops/glv.py): every 255-bit Fr scalar splits into two 128-bit
half-scalars against the curve endomorphism phi(x, y) = (beta*x, y), halving
the Horner window chain of every scalar-mul/MSM; signed 4-bit digits then
halve the multiples tables (9 magnitudes instead of 16 entries — point
negation is free, -(X:Y:Z) = (X:-Y:Z)).

Math (verified in tests/test_glv.py):
  * lambda = z^2 - 1 with z = -0xd201000000010000 (the BLS parameter), so
    r = lambda^2 + lambda + 1. Hence the decomposition needs NO lattice
    rounding: s = s1 + lambda*s2 with (s2, s1) = divmod(s, lambda) keeps
    both halves < 2^128 (s2 <= (r-1)/lambda = lambda + 1).
  * beta is the cube root of unity in Fp matching phi(P) = [lambda]P on G1.
  * signed recode: digits of (half + BIAS) in base 16 minus 8 give the
    canonical [-8,7] signed-digit form in one integer add — no carry scan.
    half + BIAS < 2^129 -> 33 windows (NUM_WINDOWS).
  * subgroup membership: P in G1  <=>  [lambda]P == phi(P) (Scott,
    "A note on group membership tests..."), replacing the reference's
    full-width [r]P == O (gnark SetBytes subgroup check) at half the cost.
    The [lambda]P side MUST NOT itself use the phi shortcut (circular);
    callers pass `digits_nophi` of lambda.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..utils import field_host as fh

# lambda = z^2 - 1, z = -0xd201000000010000  (128 bits)
LAMBDA = 0xAC45A4010001A40200000000FFFFFFFF
assert LAMBDA * LAMBDA + LAMBDA + 1 == fh.R

# cube root of unity in Fp with (beta*x, y) == [lambda](x, y) on G1
BETA = int(
    "1a0111ea397fe699ec02408663d4de85aa0d857d89759ad4897d29650fb85f9b"
    "409427eb4f49fffd8bfd00000000aaac", 16)
assert (BETA * BETA + BETA + 1) % fh.P == 0

WINDOW_BITS = 4
SIG_WINDOWS = 33            # significant windows of a 129-bit biased half
NUM_WINDOWS = 33
TABLE_SIZE = 9              # digit magnitudes 0..8

# bias trick: signed [-8,7] digits of s == unsigned digits of s+BIAS, -8
BIAS = int("88" * 16, 16)   # 8 * (16^32 - 1) / 15


def split(s: int) -> Tuple[int, int]:
    """s -> (s1, s2) with s = s1 + LAMBDA*s2 (mod r), both < 2^128."""
    s2, s1 = divmod(s % fh.R, LAMBDA)
    return s1, s2


def _recode_half(h: np.ndarray) -> np.ndarray:
    """[n] array of python-int 128-bit halves -> [n, SIG_WINDOWS] signed
    digits, LSB window first."""
    n = len(h)
    buf = b"".join(int(v + BIAS).to_bytes(17, "little") for v in h)
    byts = np.frombuffer(buf, np.uint8).reshape(n, 17).astype(np.int32)
    lo = byts & 15
    hi = byts >> 4
    nibs = np.stack([lo, hi], axis=-1).reshape(n, 34)   # LSB nibble first
    digs = nibs[:, :SIG_WINDOWS].copy()
    digs[:, :32] -= 8
    return digs


def scalars_to_digits_glv(scalars: Sequence[int]) -> np.ndarray:
    """[n] ints -> [2n, NUM_WINDOWS] int32 signed digits, MSB window first,
    lanes interleaved: row 2i = s1_i (for P_i), row 2i+1 = s2_i (for
    phi(P_i)). MSB zero-padding keeps the Horner combine exact."""
    n = len(scalars)
    halves = np.empty(2 * n, dtype=object)
    for i, s in enumerate(scalars):
        s1, s2 = split(int(s))
        halves[2 * i] = s1
        halves[2 * i + 1] = s2
    digs = _recode_half(halves)                      # [2n, 33] LSB first
    return np.ascontiguousarray(digs[:, ::-1])       # MSB window first


def digits_nophi(s: int, n_lanes: int) -> np.ndarray:
    """[2*n_lanes, NUM_WINDOWS] digit rows computing an HONEST [s]P per lane
    (s < 2^128; the phi lanes get zero digits). Used by the subgroup check,
    where routing through the endomorphism would be circular."""
    assert 0 <= s < (1 << 128)
    digs = _recode_half(np.array([s], dtype=object))   # [1, 33]
    out = np.zeros((2 * n_lanes, NUM_WINDOWS), np.int32)
    out[0::2] = digs[0, ::-1]
    return out
