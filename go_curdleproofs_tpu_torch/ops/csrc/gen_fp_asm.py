#!/usr/bin/env python3
"""Writes fp_asm.cuh and fr_asm.cuh: the product, square, addition and
subtraction of the BLS12-381 base field Fp (12 words) and scalar field Fr
(8 words) as straight-line PTX with hardware carry chains, and Fr's
reduction of raw words.

    python3 go_curdleproofs_tpu_torch/ops/csrc/gen_fp_asm.py [--check]

One generator serves both fields: a `Field` is a modulus, a word count and
a name prefix (fp_mul_words, fr_mul_words, ...). Each function is ONE
`asm volatile` statement, so that no carry flag has to survive from one
statement to the next. Writing 600 lines of PTX with 36 numbered operands
by hand invites a slip that random inputs never hit, so the text is
generated here, and tests/test_torch_fp_product.py and
tests/test_torch_fr_product.py run the generated text, instruction by
instruction, through a small PTX interpreter on the CPU (every carry
accounted for) before the card ever compiles it. --check fails when either
header is not what this script writes.

Layout of the product (the one sppark and CGBN use for 12-word Montgomery
on NVIDIA cards): a 32x32->64 multiply-add is the pair mad.lo.cc /
madc.hi.cc on two neighbouring words, which the card runs as one wide
multiply-add with carry in and out. The partial products a[j] * b_i of one
row with j even land on word pairs (j, j+1) and chain into the accumulator
`even`; those with j odd land on pairs shifted by one word and chain into
`odd`, which stands one word higher. Neither chain needs a carry fix-up per
multiply-add, and the two are independent of each other. The Montgomery
step (m = even[0] * -p^-1, add m * p) uses the same two chains with p's
words as immediates; it clears even[0], so dividing by 2^32 is a change of
roles: `odd` becomes the next row's `even`, and the old `even`, read two
words up, the next `odd` (the shift rides on the multiply-add's separate
addend operand and costs nothing).

Bounds (why no carry leaves the top word). Inputs are below p < 2^381.
With E, O the values of the two accumulators, the row's total is
T = E + 2^32 O < 2p after its division, as in any Montgomery product. All
terms are non-negative, so a partial sum never exceeds the final one. The
carry out of the top of `even` is added into odd[11] (twice a row, each at
most 1). `odd` receives, per row, at most (old even >> 64) < 2^320, the odd
words of a times b_i, below 2^349 * 2^32 (a's top word is below 2^29), the
odd words of p times m, again below 2^381, and those two carries at 2^352:
below 2^383 in all, so its top word never overflows and the chains that end
in it end without a carry (madc.hi without .cc). The merged result is
T < 2p < 2^382, and one conditional subtraction makes it canonical.

Fr (r < 2^255, its top word 0x73eda753; 8 words, odd's top word is word 7
of `odd`, 2^224 in its value) has less room. For a below r the argument
above holds with the top words in place of powers of two: per row `odd`
receives old even >> 64 < 2^192, the odd words of a times b_i, below
0x73eda754 * 2^192 * 2^32, the odd words of r times m, the same, and two
carries of 2^224: below 0xe7db4ea9 * 2^224 < 2^256, so its top word never
overflows either. For a raw a, any value below 2^256 = R, it does not
hold: a's top word may be 0xffffffff, and the row total T_i < a + r then
reaches past 2^256 (a = 2^256 - 1 against b = r - 1 carries out of odd's
top word: tests/test_torch_fr_product.py runs it). Raw words are how
values enter Montgomery form (ops/fr.py: from_bytes_be multiplies raw
words by R^2 mod r), so Fr has one more function, fr_reduce_words: a mod r
for any a below 2^256, by two conditional subtractions of r (2^256 < 3r),
2 x 18 instructions. The kernel that takes raw words (fr_mont_mul) calls
it once where they enter; fr_mul_words, like fp_mul_words, takes operands
below r only, so the ladder's products do not pay for it. The square takes
canonical operands too, and its bounds hold as for Fp: a^2 < 2^510, the
low half's Montgomery rows end at most r, the high half is below
0.4528 r, so the sum is below 2r < 2^256.

The square forms the 24-word a^2 first: the 66 products a_i a_j, i < j,
taken diagonal by diagonal (fixed j - i: their word pairs follow each other
two words apart, one carry chain), shortest diagonal first, so that both
ends of every chain fall on words nothing has touched yet and no carry
ripples upward; even and odd diagonals in two accumulators as above; the
sum doubled by funnel shifts; the 12 squares a_i^2 added in one chain over
all 24 words. Then the low 12 words are reduced by 12 Montgomery-only rows
of the same two-chain form (result at most p), the high 12 words (below
p / 8) are added, and one conditional subtraction follows: 78 + 144 wide
multiply-adds against the product's 288.
"""

import argparse
import sys
from pathlib import Path

MASK = 0xFFFFFFFF
HERE = Path(__file__).resolve().parent


class Field:
    """A prime field's generated header: the modulus, its word count and
    the prefix of its function names. `raw_entry`: the header also holds
    <prefix>_reduce_words, a mod p for any a below 2^(32 nw)."""

    def __init__(self, modulus, nw, prefix, header, what, test,
                 raw_entry=False):
        self.p, self.nw, self.prefix = modulus, nw, prefix
        self.out = HERE / header
        self.what, self.test, self.raw_entry = what, test, raw_entry
        self.m0 = (-pow(modulus, -1, 1 << 32)) & MASK       # -p^-1 mod 2^32
        self.pw = [f"0x{(modulus >> (32 * j)) & MASK:08x}" for j in range(nw)]
        assert modulus < 1 << (32 * nw - 1)
        assert not raw_entry or 3 * modulus > 1 << (32 * nw)


FP = Field(int("1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
               "1eabfffeb153ffffb9feffffffffaaab", 16), 12, "fp", "fp_asm.cuh",
           "The BLS12-381 base field's", "tests/test_torch_fp_product.py")
FR = Field(int("73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001",
               16), 8, "fr", "fr_asm.cuh", "The BLS12-381 scalar field's",
           "tests/test_torch_fr_product.py", raw_entry=True)
FIELDS = (FP, FR)


class Block:
    """Instructions of one asm statement. Operands %0..%(nw-1) are the
    output words, %nw.. the words of the inputs."""

    def __init__(self, n_inputs, nw):
        self.n_inputs = n_inputs
        self.nw = nw
        self.ins = []
        self.families = {}

    def regs(self, name, count):
        self.families[name] = count
        return [f"{name}{j}" for j in range(count)]

    def reg(self, name):
        self.families[name] = 0
        return name

    def emit(self, op, *args):
        self.ins.append(f"{op} {', '.join(args)};")

    def outputs(self):
        return [f"%{j}" for j in range(self.nw)]

    def input(self, k):
        return [f"%{self.nw * (k + 1) + j}" for j in range(self.nw)]


def mul_n(b, dst, src, k):
    """dst[j], dst[j+1] = k * src[j] for even j (fresh registers)."""
    for j in range(0, b.nw, 2):
        b.emit("mul.lo.u32", dst[j], k, src[j])
        b.emit("mul.hi.u32", dst[j + 1], k, src[j])


def cmad_n(b, acc, src, k, carry_out=True):
    """acc[j], acc[j+1] += k * src[j] for even j, one chain. Without
    carry_out the chain ends in a word that the bounds keep from
    overflowing."""
    nw = b.nw
    for j in range(0, nw, 2):
        b.emit("mad.lo.cc.u32" if j == 0 else "madc.lo.cc.u32",
               acc[j], k, src[j], acc[j])
        last = j == nw - 2 and not carry_out
        b.emit("madc.hi.u32" if last else "madc.hi.cc.u32",
               acc[j + 1], k, src[j], acc[j + 1])


def madc_n_rshift(b, odd, src, k):
    """odd[j], odd[j+1] = k * src[j] + odd[j+2], odd[j+3] for even j: the
    chain goes on from the carry flag and moves `odd` down two words."""
    nw = b.nw
    for j in range(0, nw - 2, 2):
        b.emit("madc.lo.cc.u32", odd[j], k, src[j], odd[j + 2])
        b.emit("madc.hi.cc.u32", odd[j + 1], k, src[j], odd[j + 3])
    b.emit("madc.lo.cc.u32", odd[nw - 2], k, src[nw - 2], "0")
    b.emit("madc.hi.u32", odd[nw - 1], k, src[nw - 2], "0")


def montgomery_step(b, f, even, odd, mi, first_odd=False):
    """even, odd += m * p with m = even[0] * -p^-1: clears even[0]."""
    if first_odd:
        mul_n(b, odd, f.pw[1:], mi)
    else:
        cmad_n(b, odd, f.pw[1:], mi, carry_out=False)
    cmad_n(b, even, f.pw, mi)
    b.emit("addc.u32", odd[f.nw - 1], odd[f.nw - 1], "0")


def merge(b, even, odd):
    """After the last row `even` (even[0] == 0) stands one word below
    `odd`: odd += even >> 32."""
    nw = b.nw
    b.emit("add.cc.u32", odd[0], odd[0], even[1])
    for j in range(1, nw - 1):
        b.emit("addc.cc.u32", odd[j], odd[j], even[j + 1])
    b.emit("addc.u32", odd[nw - 1], odd[nw - 1], "0")


def reduce_once(b, f, t, out):
    """out = t - p if t >= p else t, for t < 2p (out may be t)."""
    nw = f.nw
    d = b.regs("df", nw)
    br, q = b.reg("bw"), "qq"
    for j in range(nw):
        b.emit("sub.cc.u32" if j == 0 else "subc.cc.u32", d[j], t[j], f.pw[j])
    b.emit("subc.u32", br, d[nw - 1], d[nw - 1])      # 0 - borrow
    b.emit("setp.ne.u32", q, br, "0")
    for j in range(nw):
        b.emit("selp.u32", out[j], t[j], d[j], q)


def gen_mul(f):
    nw = f.nw
    b = Block(2, nw)
    a, bb = b.input(0), b.input(1)
    even, odd = b.regs("ev", nw), b.regs("od", nw)
    mi = b.reg("mi")
    for i in range(nw):
        if i == 0:
            mul_n(b, odd, a[1:], bb[0])
            mul_n(b, even, a, bb[0])
        else:
            b.emit("add.cc.u32", even[0], even[0], odd[1])
            madc_n_rshift(b, odd, a[1:], bb[i])
            cmad_n(b, even, a, bb[i])
            b.emit("addc.u32", odd[nw - 1], odd[nw - 1], "0")
        b.emit("mul.lo.u32", mi, even[0], f"0x{f.m0:08x}")
        montgomery_step(b, f, even, odd, mi)
        even, odd = odd, even
    merge(b, odd, even)
    reduce_once(b, f, even, b.outputs())
    return b


def gen_sqr(f):
    nw = f.nw
    b = Block(1, nw)
    a = b.input(0)
    acc = {"x": b.regs("xx", 2 * nw), "y": b.regs("yy", 2 * nw)}
    touched = set()

    def addend(r):
        return r if r in touched else "0"

    # a_i * a_(i+d) lies on words (2i + d, 2i + d + 1)
    for d in range(nw - 1, 0, -1):
        regs = acc["x" if d % 2 else "y"]
        for i in range(nw - d):
            lo, hi = regs[2 * i + d], regs[2 * i + d + 1]
            last = i == nw - d - 1
            b.emit("mad.lo.cc.u32" if i == 0 else "madc.lo.cc.u32",
                   lo, a[i], a[i + d], addend(lo))
            b.emit("madc.hi.u32" if last else "madc.hi.cc.u32",
                   hi, a[i], a[i + d], addend(hi))
            touched.update((lo, hi))
    x, y = acc["x"], acc["y"]
    top = 2 * nw - 2
    # x (words 1..2nw-2) += y (words 2..2nw-3)
    for w in range(2, top):
        b.emit("add.cc.u32" if w == 2 else "addc.cc.u32", x[w], x[w], y[w])
    b.emit("addc.u32", x[top], x[top], "0")
    # t = 2 x + the squares
    dbl = b.regs("zz", 2 * nw)
    b.emit("shl.b32", dbl[1], x[1], "1")
    for w in range(2, 2 * nw - 1):
        b.emit("shf.l.wrap.b32", dbl[w], x[w - 1], x[w], "1")
    b.emit("shr.u32", dbl[top + 1], x[top], "31")
    t = b.regs("tt", 2 * nw)
    b.emit("mul.lo.u32", t[0], a[0], a[0])
    b.emit("mad.hi.cc.u32", t[1], a[0], a[0], dbl[1])
    for i in range(1, nw):
        b.emit("madc.lo.cc.u32", t[2 * i], a[i], a[i], dbl[2 * i])
        b.emit("madc.hi.u32" if i == nw - 1 else "madc.hi.cc.u32",
               t[2 * i + 1], a[i], a[i], dbl[2 * i + 1])
    # Montgomery-only rows on the low half
    even, odd = t[:nw], b.regs("od", nw)
    mi = b.reg("mi")
    for i in range(nw):
        if i == 0:
            b.emit("mul.lo.u32", mi, even[0], f"0x{f.m0:08x}")
            montgomery_step(b, f, even, odd, mi, first_odd=True)
        else:
            b.emit("add.cc.u32", even[0], even[0], odd[1])
            b.emit("mul.lo.u32", mi, even[0], f"0x{f.m0:08x}")
            madc_n_rshift(b, odd, f.pw[1:], mi)
            cmad_n(b, even, f.pw, mi)
            b.emit("addc.u32", odd[nw - 1], odd[nw - 1], "0")
        even, odd = odd, even
    merge(b, odd, even)
    for j in range(nw):                        # the high half
        op = "add.cc.u32" if j == 0 else (
            "addc.u32" if j == nw - 1 else "addc.cc.u32")
        b.emit(op, even[j], even[j], t[nw + j])
    reduce_once(b, f, even, b.outputs())
    return b


def gen_reduce(f):
    """a mod p for a below 2^(32 nw) < 3p: two conditional subtractions."""
    b = Block(1, f.nw)
    t = b.regs("ra", f.nw)
    reduce_once(b, f, b.input(0), t)
    reduce_once(b, f, t, b.outputs())
    return b


def gen_add(f):
    nw = f.nw
    b = Block(2, nw)
    x, y = b.input(0), b.input(1)
    t = b.regs("tt", nw)
    for j in range(nw):                        # a + b < 2p < 2^(32 nw)
        op = "add.cc.u32" if j == 0 else (
            "addc.u32" if j == nw - 1 else "addc.cc.u32")
        b.emit(op, t[j], x[j], y[j])
    reduce_once(b, f, t, b.outputs())
    return b


def gen_sub(f):
    """a - b, plus p where that went below zero. The last addc wraps past
    2^(32 nw) on purpose in that case (it undoes the borrow)."""
    nw = f.nw
    b = Block(2, nw)
    x, y = b.input(0), b.input(1)
    t, pm = b.regs("tt", nw), b.regs("df", nw)
    br = b.reg("bw")
    for j in range(nw):
        b.emit("sub.cc.u32" if j == 0 else "subc.cc.u32", t[j], x[j], y[j])
    b.emit("subc.u32", br, t[nw - 1], t[nw - 1])      # all ones on a borrow
    for j in range(nw):
        b.emit("and.b32", pm[j], br, f.pw[j])
    out = b.outputs()
    for j in range(nw):
        op = "add.cc.u32" if j == 0 else (
            "addc.u32" if j == nw - 1 else "addc.cc.u32")
        b.emit(op, out[j], t[j], pm[j])
    return b


def functions(f):
    """(name, block, what it computes, its operands' contract)."""
    bits, m = 32 * f.nw, f.prefix[1]
    canon = "inputs and result fully reduced"
    fns = ((f"{f.prefix}_mul_words", gen_mul(f),
            f"r = a * b / 2^{bits} mod {m}", canon),
           (f"{f.prefix}_sqr_words", gen_sqr(f),
            f"r = a * a / 2^{bits} mod {m}", canon),
           (f"{f.prefix}_add_words", gen_add(f), f"r = a + b mod {m}", canon),
           (f"{f.prefix}_sub_words", gen_sub(f), f"r = a - b mod {m}", canon))
    if f.raw_entry:
        fns += ((f"{f.prefix}_reduce_words", gen_reduce(f), f"r = a mod {m}",
                 f"a any value below 2^{bits}, the result fully reduced"),)
    return fns


def render_function(name, block, what, contract):
    nw = block.nw
    words = f"uint32_t (&r)[{nw}]" + "".join(
        f",\n    const uint32_t (&{v})[{nw}]" for v in "ab"[:block.n_inputs])
    decl = ", ".join(f"{fam}<{n}>" if n else fam
                     for fam, n in block.families.items())
    lines = [f"// {what}; {contract}, {len(block.ins)} "
             f"instructions.",
             f"__device__ __forceinline__ void {name}({words}) {{",
             "  asm volatile(",
             '      "{\\n\\t"',
             f'      ".reg .u32 {decl};\\n\\t"',
             '      ".reg .pred qq;\\n\\t"']
    lines += [f'      "{ins}\\n\\t"' for ins in block.ins]
    lines.append('      "}"')
    lines.append("      : " + ", ".join(f'"=r"(r[{j}])' for j in range(nw)))
    ins = [f'"r"({v}[{j}])' for v in "ab"[:block.n_inputs]
           for j in range(nw)]
    lines.append("      : " + ", ".join(ins) + ");")
    lines.append("}")
    return "\n".join(lines)


def render(f=FP):
    head = [
        "// GENERATED by gen_fp_asm.py (same directory): do not edit, run",
        f"// the script. {f.what} product, square, sum and",
        f"// difference on {f.nw} little-endian 32-bit words, each ONE asm",
        "// statement of straight-line PTX with hardware carry chains; the",
        "// script's docstring explains the layout and the bounds, and",
        f"// {f.test} interprets this text on the CPU.",
        "// A function writes its outputs only after its last read of an",
        "// input, so an output may share a register with an input.",
        *([f"// {f.prefix}_reduce_words brings raw words (any value below",
           f"// 2^{32 * f.nw}) below {f.prefix[1]} where they enter."]
          if f.raw_entry else []),
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace curdle {",
        ""]
    body = [render_function(*fn) + "\n" for fn in functions(f)]
    return "\n".join(head + body + ["}  // namespace curdle", ""])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="fail if a header differs from what would be "
                         "written")
    args = ap.parse_args()
    stale = []
    for f in FIELDS:
        text = render(f)
        if args.check:
            if not f.out.exists() or f.out.read_text() != text:
                stale.append(f.out.name)
            continue
        f.out.write_text(text)
        print(f"wrote {f.out} ({len(text.splitlines())} lines)")
    if stale:
        print(f"{', '.join(stale)} out of date: run gen_fp_asm.py",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
