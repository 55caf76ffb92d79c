"""The Fr product, square, sum and difference of ops/csrc/fr_asm.cuh, and
the windowed ladder of fr_pow_fixed, checked on the CPU.

fr_asm.cuh is written by ops/csrc/gen_fp_asm.py with fp_asm.cuh (one
generator, a modulus and a word count each) and compiled only on a card.
Here its text runs through the PTX interpreter of
tests/test_torch_fp_product.py at 8 words: a register read before it is
written, a carry that leaves a word no chain takes up, and a carry flag
left unread all fail. fr_mont_mul's first operand may be raw words, any
value below 2^256 (how values enter Montgomery form): the kernel brings
it below r with fr_reduce_words and then takes the product, which holds
canonical operands only. So the grid pairs raw first operands up to
2^256 - 1 with the edge elements through both functions, as the kernel
runs them, and one case shows, as the bound argument of the generator's
docstring says, that the product's chains overflow on a raw operand.
Results are compared with Python ints: a * b / 2^256 mod r, below r.
Tolerance 0.

The ladder model repeats fr_pow_fixed_kernel's schedule (15 powers by 7
squarings and 7 products, nibbles from the top, zero nibbles skipped)
against pow(x, e, r), on plain ints and on the interpreted text."""

import hashlib
import random

import pytest
import torch

from go_curdleproofs_tpu_torch.ops import kernels
from go_curdleproofs_tpu_torch.utils import field_host as fh
from test_torch_fp_product import (CSRC, CarryError, _generator, _parse,
                                   run_program, window_ladder)

torch.set_num_threads(1)
R = fh.R
NW = 8
MASK = 0xFFFFFFFF
RR = 1 << 256
R_INV = pow(RR, -1, R)
PROGRAMS = _parse((CSRC / "fr_asm.cuh").read_text())
# fp_asm.cuh as the Fp kernels were built before the generator took a
# second field: the Fp text must not move
FP_ASM_SHA256 = \
    "bae766f01d6d5d5e45a66ce3f8c529b1766464930c3830b5032dfefaf87b51de"


def run(name, *inputs, wrap_last=False):
    return run_program(PROGRAMS[name], NW, *inputs, wrap_last=wrap_last,
                       name=name)


def _words(v):
    return [(v >> (32 * j)) & MASK for j in range(NW)]


def _value(ws):
    return sum(w << (32 * j) for j, w in enumerate(ws))


# -- inputs ---------------------------------------------------------------------

def edge_elements():
    """~40 elements below r on which a lost carry would show."""
    rng = random.Random(6)
    vals = [0, 1, 2, R - 1, R - 2, (R + 1) // 2, (R - 1) // 2, RR % R,
            RR * RR % R, 1 << 254, (1 << 254) - 1, R - (1 << 224)]
    for k in (31, 32, 33, 63, 64, 65, 127, 128, 223, 224, 225):
        vals += [1 << k, (1 << k) - 1]
    for j in range(NW):          # one word all zeros, one word all ones
        for fill in (0, MASK):
            ws = _words(rng.randrange(R))
            ws[j] = fill
            if j == NW - 1 and fill:
                ws = [MASK] * (NW - 1) + [(R >> 224) - 1]
            vals.append(_value(ws))
    assert all(0 <= v < R for v in vals)
    return vals


def raw_words():
    """First operands at or above r: raw 32-byte values below 2^256."""
    vals = [RR - 1, RR - 2, R, R + 1, 2 * R - 1, 2 * R, 2 * R + 1, RR - R,
            (2 * R + RR) // 2, RR - 1 - (1 << 224), (RR - 1) ^ (1 << 31),
            MASK << 224, (MASK << 224) | 1, ((R >> 224) + 1) << 224]
    assert all(R <= v < RR for v in vals)
    return vals


EDGE = edge_elements()
RAW = raw_words()
EDGE_PAIRS = [(a, b) for a in EDGE for b in EDGE]
RAW_PAIRS = [(a, b) for a in RAW for b in EDGE]


def random_pairs(n=2000, seed=12):
    """Half with a raw first operand below 2^256, half below r."""
    rng = random.Random(seed)
    return [(rng.randrange(RR if i % 2 else R), rng.randrange(R))
            for i in range(n)]


assert (RR - 1, R - 1) in RAW_PAIRS
INPUTS = {"edge grid": EDGE_PAIRS, "raw first operands": RAW_PAIRS,
          "random": random_pairs()}


# -- the header ------------------------------------------------------------------

def test_headers_are_what_the_generator_writes():
    gen = _generator()
    assert (CSRC / "fr_asm.cuh").read_text() == gen.render(gen.FR)
    assert (CSRC / "fp_asm.cuh").read_text() == gen.render(gen.FP)
    assert hashlib.sha256((CSRC / "fp_asm.cuh").read_bytes()).hexdigest() \
        == FP_ASM_SHA256
    assert gen.FR.p == R and gen.FR.m0 == (-pow(R, -1, 1 << 32)) & MASK
    assert set(PROGRAMS) == {"fr_mul_words", "fr_sqr_words", "fr_add_words",
                             "fr_sub_words", "fr_reduce_words"}


def test_header_is_a_build_source():
    """A changed product must rebuild the libraries."""
    assert "fr_asm.cuh" in kernels._SOURCES
    assert '#include "fr_asm.cuh"' in (CSRC / "fr.cuh").read_text()


# -- the five functions ----------------------------------------------------------

@pytest.mark.parametrize("inputs", list(INPUTS))
def test_product_text_equals_montgomery_product(inputs):
    """fr_mont_mul_kernel's path: fr_reduce_words on the first operand,
    then the product."""
    for a, b in INPUTS[inputs]:
        ar = run("fr_reduce_words", a)
        assert ar == a % R, hex(a)
        assert run("fr_mul_words", ar, b) == a * b * R_INV % R, (hex(a),
                                                                 hex(b))


def test_product_without_the_reduction_of_a_overflows():
    """The generator's bound argument: canonical first operands fit the
    product's chains; a raw 2^256 - 1 against r - 1 carries out of the odd
    accumulator's top word, which is why raw words are reduced first."""
    with pytest.raises(CarryError):
        run("fr_mul_words", RR - 1, R - 1)


@pytest.mark.parametrize("inputs", ["edge grid", "random"])
def test_square_text_equals_montgomery_square_and_product(inputs):
    pairs = INPUTS[inputs]
    for a in sorted({a % R for a, _ in pairs} | {b for _, b in pairs[:200]}):
        assert run("fr_sqr_words", a) == a * a * R_INV % R, hex(a)
    for a, _ in pairs[:50]:
        a %= R
        assert run("fr_sqr_words", a) == run("fr_mul_words", a, a)


@pytest.mark.parametrize("inputs", ["edge grid", "random"])
def test_sum_and_difference_text(inputs):
    for a, b in INPUTS[inputs]:
        a %= R
        assert run("fr_add_words", a, b) == (a + b) % R
        assert run("fr_sub_words", a, b, wrap_last=True) == (a - b) % R


def test_instruction_counts():
    """36 + 64 wide multiply-adds a square against 128 a product: a pair
    mad.lo / madc.hi (or mul.lo / mul.hi) is one of them. The reduction of
    raw words, two subtractions of r, is 36 instructions."""
    def wide(name):
        return sum(op.split(".")[0] in ("mad", "madc", "mul")
                   and op.split(".")[1] == "hi" for op, _ in PROGRAMS[name])
    assert wide("fr_mul_words") == 128
    assert wide("fr_sqr_words") == 28 + 8 + 64
    assert len(PROGRAMS["fr_sqr_words"]) < len(PROGRAMS["fr_mul_words"]) < 400
    assert len(PROGRAMS["fr_reduce_words"]) == 36
    assert wide("fr_reduce_words") == 0


# -- the windowed ladder ----------------------------------------------------------

EXPONENTS = {
    "1": 1, "2": 2, "15": 15, "16": 16, "17": 17,
    "2^255-1": (1 << 255) - 1, "2^256-1": (1 << 256) - 1,
    "zero nibbles": 0x9000A00000B0000C0D, "bits 4k+1": 0x1F3,
    "bits 4k+2": 0x2F03, "bits 4k+3": 0x7000F, "inverse": R - 2,
}
ON_TEXT = ("1", "2", "15", "16", "17", "bits 4k+1", "bits 4k+2", "bits 4k+3",
           "inverse")


@pytest.mark.parametrize("name", list(EXPONENTS))
def test_window_ladder_on_ints(name):
    e = EXPONENTS[name]
    rng = random.Random(e & 0xFFFF)
    for x in [0, 1, R - 1] + [rng.randrange(R) for _ in range(5)]:
        got, n_sqr, n_mul = window_ladder(
            x, e, lambda a, b: a * b % R, lambda a: a * a % R, bits=256)
        assert got == pow(x, e, R)
    if name == "inverse":
        # 7 + 252 squarings and 7 + at most 63 products against the 417
        # general products of one bit a step
        assert n_sqr == 7 + 252 and n_mul <= 7 + 63
        assert e.bit_length() - 1 + bin(e).count("1") - 1 == 417


@pytest.mark.parametrize("name", ON_TEXT)
def test_window_ladder_on_the_interpreted_text(name):
    """The same schedule on Montgomery words through the PTX text."""
    e = EXPONENTS[name]
    rng = random.Random(e)
    xs = (0, 1, R - 1, rng.randrange(R)) if name != "inverse" else (
        0, rng.randrange(R))
    for x in xs:
        got, _, _ = window_ladder(
            x * RR % R, e, lambda a, b: run("fr_mul_words", a, b),
            lambda a: run("fr_sqr_words", a), bits=256)
        assert got * R_INV % R == pow(x, e, R)


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _raw_tensor(vals, device):
    """[n, 8] int32 words of values below 2^256 as they are (raw)."""
    return torch.tensor([[w - (1 << 32) if w >> 31 else w for w in _words(v)]
                         for v in vals], dtype=torch.int32, device=device)


@pytest.mark.cuda
def test_cuda_fr_product_grid_square_and_ladder(cuda_device):
    """fr_mont_mul on the edge grid and the raw first operands against the
    plain version and Python ints; the square (fr_pow_fixed at 2) against
    the product; B8 at every exponent of the ladder model."""
    pairs = EDGE_PAIRS + RAW_PAIRS
    a = _raw_tensor([u for u, _ in pairs], cuda_device)
    b = _raw_tensor([v for _, v in pairs], cuda_device)
    got = kernels.fr_mont_mul(a, b)
    assert torch.equal(got, kernels.fr_mont_mul_plain(a, b))
    assert [_value([w & MASK for w in row]) for row in got.tolist()] == \
        [u * v * R_INV % R for u, v in pairs]
    x = b[:len(EDGE)].contiguous()
    assert torch.equal(kernels.fr_pow_fixed(x, 2), kernels.fr_mont_mul(x, x))
    for e in EXPONENTS.values():
        want = kernels.fr_pow_fixed_plain(x, e)
        assert torch.equal(kernels.fr_pow_fixed(x, e), want), hex(e)
