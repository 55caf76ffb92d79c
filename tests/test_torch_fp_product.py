"""The Fp product, square, sum and difference of ops/csrc/fp_asm.cuh, and
the windowed ladder of pow_fixed, checked on the CPU.

The CUDA kernels run only on a card. What can be checked here is the
arithmetic they are made of: fp_asm.cuh is straight-line PTX, one asm
statement a function, written by ops/csrc/gen_fp_asm.py. This file reads
that text as it is compiled on the card and runs it through a word-level
interpreter of the dozen PTX instructions it uses (32-bit registers as
Python ints, one carry flag). The interpreter fails on a register read
before it is written, on a carry that leaves a word no chain takes up, and
on a carry flag that is overwritten or left behind unread: a lost carry
shows on rare words only, so the inputs are an edge grid (every pair of ~40
elements) and 2,000 seeded random pairs. Results are compared with Python
ints: a * b / 2^384 mod p, below p. Tolerance 0.

The ladder model repeats pow_fixed_kernel's schedule (15 powers by 7
squarings and 7 products, nibbles from the top, zero nibbles skipped)
against pow(x, e, p), on plain ints for every exponent of the list and on
the interpreted PTX for the short ones."""

import importlib.util
import random
import re
from pathlib import Path

import pytest
import torch

from go_curdleproofs_tpu_torch.ops import kernels
from go_curdleproofs_tpu_torch.utils import field_host as fh

torch.set_num_threads(1)
P = fh.P
NW = 12
MASK = 0xFFFFFFFF
R = 1 << 384
R_INV = pow(R, -1, P)
CSRC = Path(kernels.__file__).parent / "csrc"


def _generator():
    spec = importlib.util.spec_from_file_location("gen_fp_asm",
                                                  CSRC / "gen_fp_asm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the interpreter ------------------------------------------------------------

class CarryError(AssertionError):
    pass


_INS = re.compile(r'^\s*"([a-z][a-z0-9.]*) ([^;]*);\\n\\t"$')


def _parse(text):
    """{function: [(opcode, [operands])]} from the generated header."""
    fns, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"void (\w+)\(", line)
        if m:
            cur = fns.setdefault(m.group(1), [])
            continue
        m = _INS.match(line)
        if m and cur is not None:
            cur.append((m.group(1), [s.strip() for s in m.group(2).split(",")]))
    return fns


PROGRAMS = _parse((CSRC / "fp_asm.cuh").read_text())


def _words(v):
    return [(v >> (32 * j)) & MASK for j in range(NW)]


def _value(ws):
    return sum(w << (32 * j) for j, w in enumerate(ws))


def run(name, *inputs, wrap_last=False):
    """Executes one function of fp_asm.cuh on integer inputs; returns the
    integer its 12 output words hold. `wrap_last`: the last instruction may
    carry out of its word (fp_sub's add of p undoes a borrow that way)."""
    prog = PROGRAMS[name]
    regs = {}
    for k, v in enumerate(inputs):
        for j, w in enumerate(_words(v)):
            regs[f"%{NW * (k + 1) + j}"] = w
    carry = 0          # the flag
    unread = False     # it holds a carry no instruction has taken up yet

    def val(s):
        if s.startswith("0x"):
            return int(s, 16)
        if s.isdigit():
            return int(s)
        return regs[s]                     # KeyError: read before written

    for n, (op, args) in enumerate(prog):
        parts = op.split(".")
        base = parts[0]
        dst, src = args[0], [val(s) for s in args[1:]]
        writes_cc = "cc" in parts
        if base in ("add", "addc", "sub", "subc", "mad", "madc"):
            reads_cc = base.endswith("c") and base != "sub"
            if base in ("mad", "madc"):
                prod = src[0] * src[1]
                prod = prod >> 32 if "hi" in parts else prod & MASK
                total = prod + src[2]
            elif base in ("add", "addc"):
                total = src[0] + src[1]
            else:
                total = src[0] - src[1]
            if reads_cc:
                total += -carry if base == "subc" else carry
                unread = False
            elif unread:
                raise CarryError(f"{name}:{n} {op} starts a chain over an "
                                 f"unread carry")
            out_carry = 1 if (total < 0 or total > MASK) else 0
            regs[dst] = total & MASK
            if writes_cc:
                carry, unread = out_carry, bool(out_carry)
            elif out_carry and base not in ("sub", "subc") and not (
                    wrap_last and n == len(prog) - 1):
                raise CarryError(f"{name}:{n} {op} {args}: carry out of a "
                                 f"word that no chain continues")
        elif base == "mul":
            prod = src[0] * src[1]
            regs[dst] = prod >> 32 if "hi" in parts else prod & MASK
        elif base == "shl":
            regs[dst] = (src[0] << src[1]) & MASK
        elif base == "shr":
            regs[dst] = src[0] >> src[1]
        elif base == "shf":                 # shf.l.wrap.b32 d, lo, hi, n
            regs[dst] = ((src[1] << src[2]) | (src[0] >> (32 - src[2]))) & MASK
        elif base == "and":
            regs[dst] = src[0] & src[1]
        elif base == "setp":                # setp.ne.u32
            regs[dst] = src[0] != src[1]
        elif base == "selp":
            regs[dst] = src[0] if src[2] else src[1]
        else:
            raise AssertionError(f"unknown instruction {op}")
        assert isinstance(regs[dst], bool) or 0 <= regs[dst] <= MASK
    if unread:
        raise CarryError(f"{name}: a carry is left in the flag at the end")
    return _value([regs[f"%{j}"] for j in range(NW)])


# -- inputs ---------------------------------------------------------------------

def edge_elements():
    rng = random.Random(5)
    vals = [0, 1, 2, P - 1, P - 2, (P + 1) // 2, (P - 1) // 2, R % P,
            R * R % P, (1 << 380), (1 << 380) - 1, (1 << 381) - 1 - (1 << 380)]
    for k in (31, 32, 33, 63, 64, 65, 191, 192, 193, 351, 352, 353):
        vals += [1 << k, (1 << k) - 1]
    for j in range(NW):          # one word all zeros, one word all ones
        for fill in (0, MASK):
            ws = _words(rng.randrange(P))
            ws[j] = fill
            if j == NW - 1 and fill:
                ws = [MASK] * (NW - 1) + [(P >> 352) - 1]
            vals.append(_value(ws))
    assert all(0 <= v < P for v in vals)
    return vals


EDGE = edge_elements()
EDGE_PAIRS = [(a, b) for a in EDGE for b in EDGE]


def random_pairs(n=2000, seed=11):
    rng = random.Random(seed)
    return [(rng.randrange(P), rng.randrange(P)) for _ in range(n)]


INPUTS = {"edge grid": EDGE_PAIRS, "random": random_pairs()}


# -- the four functions ----------------------------------------------------------

def test_header_is_what_the_generator_writes():
    gen = _generator()
    assert (CSRC / "fp_asm.cuh").read_text() == gen.render()
    assert gen.P == P and gen.M0 == (-pow(P, -1, 1 << 32)) & MASK
    assert set(PROGRAMS) == {"fp_mul_words", "fp_sqr_words", "fp_add_words",
                             "fp_sub_words"}


def test_header_is_a_build_source():
    """A changed product must rebuild the libraries."""
    assert "fp_asm.cuh" in kernels._SOURCES
    assert '#include "fp_asm.cuh"' in (CSRC / "fp.cuh").read_text()


@pytest.mark.parametrize("inputs", list(INPUTS))
def test_product_text_equals_montgomery_product(inputs):
    for a, b in INPUTS[inputs]:
        got = run("fp_mul_words", a, b)
        assert got == a * b * R_INV % P, (hex(a), hex(b))


@pytest.mark.parametrize("inputs", list(INPUTS))
def test_square_text_equals_montgomery_square_and_product(inputs):
    pairs = INPUTS[inputs]
    for a in sorted({a for a, _ in pairs} | {b for _, b in pairs[:200]}):
        got = run("fp_sqr_words", a)
        assert got == a * a * R_INV % P, hex(a)
    for a, _ in pairs[:50]:
        assert run("fp_sqr_words", a) == run("fp_mul_words", a, a)


@pytest.mark.parametrize("inputs", list(INPUTS))
def test_sum_text_equals_modular_sum(inputs):
    for a, b in INPUTS[inputs]:
        assert run("fp_add_words", a, b) == (a + b) % P


@pytest.mark.parametrize("inputs", list(INPUTS))
def test_difference_text_equals_modular_difference(inputs):
    for a, b in INPUTS[inputs]:
        assert run("fp_sub_words", a, b, wrap_last=True) == (a - b) % P


def test_interpreter_catches_a_lost_carry(monkeypatch):
    """The check is only worth what the interpreter notices: a product
    whose chains drop their carries into the odd accumulator's top word
    must fail on the edge grid."""
    prog = PROGRAMS["fp_mul_words"]
    broken = [ins for ins in prog if not (
        ins[0] == "addc.u32" and ins[1][0] == ins[1][1] and ins[1][2] == "0")]
    assert len(broken) < len(prog)
    monkeypatch.setitem(PROGRAMS, "fp_mul_words", broken)
    with pytest.raises(AssertionError):
        for a, b in EDGE_PAIRS:
            assert run("fp_mul_words", a, b) == a * b * R_INV % P


def test_instruction_counts():
    """78 + 144 wide multiply-adds a square against 288 a product: a pair
    mad.lo / madc.hi (or mul.lo / mul.hi) is one of them."""
    def wide(name):
        return sum(op.split(".")[0] in ("mad", "madc", "mul")
                   and op.split(".")[1] == "hi" for op, _ in PROGRAMS[name])
    assert wide("fp_mul_words") == 288
    assert wide("fp_sqr_words") == 66 + 12 + 144
    assert len(PROGRAMS["fp_mul_words"]) <= 700
    assert len(PROGRAMS["fp_sqr_words"]) < len(PROGRAMS["fp_mul_words"])


# -- the windowed ladder ----------------------------------------------------------

def window_ladder(x, e, mul, sqr):
    """pow_fixed_kernel's schedule; returns (x^e, squarings, products)."""
    assert 1 <= e < 1 << 384
    n_sqr = n_mul = 0
    table = [None, x]                       # table[k] = x^k, k = 1..15
    for k in range(1, 8):
        table.append(sqr(table[k]))
        table.append(mul(table[2 * k], x))
        n_sqr, n_mul = n_sqr + 1, n_mul + 1
    top = (e.bit_length() - 1) >> 2
    acc = table[(e >> (4 * top)) & 15]      # the top nibble is never 0
    for idx in range(top - 1, -1, -1):
        for _ in range(4):
            acc = sqr(acc)
        n_sqr += 4
        d = (e >> (4 * idx)) & 15
        if d:
            acc = mul(acc, table[d])
            n_mul += 1
    return acc, n_sqr, n_mul


EXPONENTS = {
    "1": 1, "2": 2, "3": 3, "15": 15, "16": 16, "17": 17,
    "2^384-1": (1 << 384) - 1, "zero nibbles": 0x9000A00000B0000C0D,
    "bits 4k+1": 0x1F3, "bits 4k+2": 0x2F03, "bits 4k+3": 0x7000F,
    "sqrt": (P + 1) // 4, "inverse": P - 2, "2^380": 1 << 380,
}
SHORT = ("1", "2", "3", "15", "16", "17", "bits 4k+1", "bits 4k+2",
         "bits 4k+3")


@pytest.mark.parametrize("name", list(EXPONENTS))
def test_window_ladder_on_ints(name):
    e = EXPONENTS[name]
    rng = random.Random(e & 0xFFFF)
    for x in [0, 1, P - 1] + [rng.randrange(P) for _ in range(5)]:
        got, n_sqr, n_mul = window_ladder(
            x, e, lambda a, b: a * b % P, lambda a: a * a % P)
        assert got == pow(x, e, P)
        nibbles = [(e >> (4 * i)) & 15 for i in range((e.bit_length() + 3) // 4)]
        assert n_sqr == 7 + 4 * (len(nibbles) - 1)
        assert n_mul == 7 + sum(d != 0 for d in nibbles[:-1])
    if name in ("sqrt", "inverse"):
        # about 400 product-times a ladder against ~570 for one bit a step
        assert n_sqr + n_mul < 490
        assert e.bit_length() - 1 + bin(e).count("1") - 1 > 560


@pytest.mark.parametrize("name", SHORT)
def test_window_ladder_on_the_interpreted_text(name):
    """The same schedule on Montgomery words through the PTX text."""
    e = EXPONENTS[name]
    rng = random.Random(e)
    for x in (0, 1, P - 1, rng.randrange(P)):
        got, _, _ = window_ladder(
            x * R % P, e, lambda a, b: run("fp_mul_words", a, b),
            lambda a: run("fp_sqr_words", a))
        assert got * R_INV % P == pow(x, e, P)
