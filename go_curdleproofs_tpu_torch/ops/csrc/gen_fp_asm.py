#!/usr/bin/env python3
"""Writes fp_asm.cuh: the BLS12-381 base field's product, square, addition
and subtraction as straight-line PTX with hardware carry chains.

    python3 go_curdleproofs_tpu_torch/ops/csrc/gen_fp_asm.py [--check]

Each function of fp_asm.cuh is ONE `asm volatile` statement, so that no
carry flag has to survive from one statement to the next. Writing 600 lines
of PTX with 36 numbered operands by hand invites a slip that random inputs
never hit, so the text is generated here, and tests/test_torch_fp_product.py
runs the generated text, instruction by instruction, through a small PTX
interpreter on the CPU (every carry accounted for) before the card ever
compiles it. --check fails when fp_asm.cuh is not what this script writes.

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

P = int("1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
        "1eabfffeb153ffffb9feffffffffaaab", 16)
NW = 12
MASK = 0xFFFFFFFF
M0 = (-pow(P, -1, 1 << 32)) & MASK          # -p^-1 mod 2^32
PW = [f"0x{(P >> (32 * j)) & MASK:08x}" for j in range(NW)]
OUT = Path(__file__).resolve().parent / "fp_asm.cuh"


class Block:
    """Instructions of one asm statement. Operands %0..%11 are the output
    words, %12.. the words of the inputs."""

    def __init__(self, n_inputs):
        self.n_inputs = n_inputs
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
        return [f"%{j}" for j in range(NW)]

    def input(self, k):
        return [f"%{NW * (k + 1) + j}" for j in range(NW)]


def mul_n(b, dst, src, k):
    """dst[j], dst[j+1] = k * src[j] for even j (fresh registers)."""
    for j in range(0, NW, 2):
        b.emit("mul.lo.u32", dst[j], k, src[j])
        b.emit("mul.hi.u32", dst[j + 1], k, src[j])


def cmad_n(b, acc, src, k, carry_out=True):
    """acc[j], acc[j+1] += k * src[j] for even j, one chain. Without
    carry_out the chain ends in a word that the bounds keep from
    overflowing."""
    for j in range(0, NW, 2):
        b.emit("mad.lo.cc.u32" if j == 0 else "madc.lo.cc.u32",
               acc[j], k, src[j], acc[j])
        last = j == NW - 2 and not carry_out
        b.emit("madc.hi.u32" if last else "madc.hi.cc.u32",
               acc[j + 1], k, src[j], acc[j + 1])


def madc_n_rshift(b, odd, src, k):
    """odd[j], odd[j+1] = k * src[j] + odd[j+2], odd[j+3] for even j: the
    chain goes on from the carry flag and moves `odd` down two words."""
    for j in range(0, NW - 2, 2):
        b.emit("madc.lo.cc.u32", odd[j], k, src[j], odd[j + 2])
        b.emit("madc.hi.cc.u32", odd[j + 1], k, src[j], odd[j + 3])
    b.emit("madc.lo.cc.u32", odd[NW - 2], k, src[NW - 2], "0")
    b.emit("madc.hi.u32", odd[NW - 1], k, src[NW - 2], "0")


def montgomery_step(b, even, odd, mi, first_odd=False):
    """even, odd += m * p with m = even[0] * -p^-1: clears even[0]."""
    if first_odd:
        mul_n(b, odd, PW[1:], mi)
    else:
        cmad_n(b, odd, PW[1:], mi, carry_out=False)
    cmad_n(b, even, PW, mi)
    b.emit("addc.u32", odd[NW - 1], odd[NW - 1], "0")


def merge(b, even, odd):
    """After the last row `even` (even[0] == 0) stands one word below
    `odd`: odd += even >> 32."""
    b.emit("add.cc.u32", odd[0], odd[0], even[1])
    for j in range(1, NW - 1):
        b.emit("addc.cc.u32", odd[j], odd[j], even[j + 1])
    b.emit("addc.u32", odd[NW - 1], odd[NW - 1], "0")


def reduce_once(b, t, out):
    """out = t - p if t >= p else t, for t < 2p."""
    d = b.regs("df", NW)
    br, q = b.reg("bw"), "qq"
    for j in range(NW):
        b.emit("sub.cc.u32" if j == 0 else "subc.cc.u32", d[j], t[j], PW[j])
    b.emit("subc.u32", br, d[NW - 1], d[NW - 1])      # 0 - borrow
    b.emit("setp.ne.u32", q, br, "0")
    for j in range(NW):
        b.emit("selp.u32", out[j], t[j], d[j], q)


def gen_mul():
    b = Block(2)
    a, bb = b.input(0), b.input(1)
    even, odd = b.regs("ev", NW), b.regs("od", NW)
    mi = b.reg("mi")
    for i in range(NW):
        if i == 0:
            mul_n(b, odd, a[1:], bb[0])
            mul_n(b, even, a, bb[0])
        else:
            b.emit("add.cc.u32", even[0], even[0], odd[1])
            madc_n_rshift(b, odd, a[1:], bb[i])
            cmad_n(b, even, a, bb[i])
            b.emit("addc.u32", odd[NW - 1], odd[NW - 1], "0")
        b.emit("mul.lo.u32", mi, even[0], f"0x{M0:08x}")
        montgomery_step(b, even, odd, mi)
        even, odd = odd, even
    merge(b, odd, even)
    reduce_once(b, even, b.outputs())
    return b


def gen_sqr():
    b = Block(1)
    a = b.input(0)
    acc = {"x": b.regs("xx", 2 * NW), "y": b.regs("yy", 2 * NW)}
    touched = set()

    def addend(r):
        return r if r in touched else "0"

    # a_i * a_(i+d) lies on words (2i + d, 2i + d + 1)
    for d in range(NW - 1, 0, -1):
        regs = acc["x" if d % 2 else "y"]
        for i in range(NW - d):
            lo, hi = regs[2 * i + d], regs[2 * i + d + 1]
            last = i == NW - d - 1
            b.emit("mad.lo.cc.u32" if i == 0 else "madc.lo.cc.u32",
                   lo, a[i], a[i + d], addend(lo))
            b.emit("madc.hi.u32" if last else "madc.hi.cc.u32",
                   hi, a[i], a[i + d], addend(hi))
            touched.update((lo, hi))
    x, y = acc["x"], acc["y"]
    # x (words 1..22) += y (words 2..21)
    for w in range(2, 2 * NW - 2):
        b.emit("add.cc.u32" if w == 2 else "addc.cc.u32", x[w], x[w], y[w])
    b.emit("addc.u32", x[22], x[22], "0")
    # t = 2 x + the squares
    dbl = b.regs("zz", 2 * NW)
    b.emit("shl.b32", dbl[1], x[1], "1")
    for w in range(2, 2 * NW - 1):
        b.emit("shf.l.wrap.b32", dbl[w], x[w - 1], x[w], "1")
    b.emit("shr.u32", dbl[23], x[22], "31")
    t = b.regs("tt", 2 * NW)
    b.emit("mul.lo.u32", t[0], a[0], a[0])
    b.emit("mad.hi.cc.u32", t[1], a[0], a[0], dbl[1])
    for i in range(1, NW):
        b.emit("madc.lo.cc.u32", t[2 * i], a[i], a[i], dbl[2 * i])
        b.emit("madc.hi.u32" if i == NW - 1 else "madc.hi.cc.u32",
               t[2 * i + 1], a[i], a[i], dbl[2 * i + 1])
    # Montgomery-only rows on the low half
    even, odd = t[:NW], b.regs("od", NW)
    mi = b.reg("mi")
    for i in range(NW):
        if i == 0:
            b.emit("mul.lo.u32", mi, even[0], f"0x{M0:08x}")
            montgomery_step(b, even, odd, mi, first_odd=True)
        else:
            b.emit("add.cc.u32", even[0], even[0], odd[1])
            b.emit("mul.lo.u32", mi, even[0], f"0x{M0:08x}")
            madc_n_rshift(b, odd, PW[1:], mi)
            cmad_n(b, even, PW, mi)
            b.emit("addc.u32", odd[NW - 1], odd[NW - 1], "0")
        even, odd = odd, even
    merge(b, odd, even)
    for j in range(NW):                        # the high half
        op = "add.cc.u32" if j == 0 else (
            "addc.u32" if j == NW - 1 else "addc.cc.u32")
        b.emit(op, even[j], even[j], t[NW + j])
    reduce_once(b, even, b.outputs())
    return b


def gen_add():
    b = Block(2)
    x, y = b.input(0), b.input(1)
    t = b.regs("tt", NW)
    for j in range(NW):                        # a + b < 2p < 2^382
        op = "add.cc.u32" if j == 0 else (
            "addc.u32" if j == NW - 1 else "addc.cc.u32")
        b.emit(op, t[j], x[j], y[j])
    reduce_once(b, t, b.outputs())
    return b


def gen_sub():
    """a - b, plus p where that went below zero. The last addc wraps past
    2^384 on purpose in that case (it undoes the borrow)."""
    b = Block(2)
    x, y = b.input(0), b.input(1)
    t, pm = b.regs("tt", NW), b.regs("df", NW)
    br = b.reg("bw")
    for j in range(NW):
        b.emit("sub.cc.u32" if j == 0 else "subc.cc.u32", t[j], x[j], y[j])
    b.emit("subc.u32", br, t[NW - 1], t[NW - 1])      # all ones on a borrow
    for j in range(NW):
        b.emit("and.b32", pm[j], br, PW[j])
    out = b.outputs()
    for j in range(NW):
        op = "add.cc.u32" if j == 0 else (
            "addc.u32" if j == NW - 1 else "addc.cc.u32")
        b.emit(op, out[j], t[j], pm[j])
    return b


FUNCTIONS = (("fp_mul_words", gen_mul, "r = a * b / 2^384 mod p"),
             ("fp_sqr_words", gen_sqr, "r = a * a / 2^384 mod p"),
             ("fp_add_words", gen_add, "r = a + b mod p"),
             ("fp_sub_words", gen_sub, "r = a - b mod p"))


def render_function(name, block, what):
    words = "uint32_t (&r)[12]" + "".join(
        f",\n    const uint32_t (&{v})[12]" for v in "ab"[:block.n_inputs])
    decl = ", ".join(f"{fam}<{n}>" if n else fam
                     for fam, n in block.families.items())
    lines = [f"// {what}; inputs and result fully reduced, {len(block.ins)} "
             f"instructions.",
             f"__device__ __forceinline__ void {name}({words}) {{",
             "  asm volatile(",
             '      "{\\n\\t"',
             f'      ".reg .u32 {decl};\\n\\t"',
             '      ".reg .pred qq;\\n\\t"']
    lines += [f'      "{ins}\\n\\t"' for ins in block.ins]
    lines.append('      "}"')
    lines.append("      : " + ", ".join(f'"=r"(r[{j}])' for j in range(NW)))
    ins = [f'"r"({v}[{j}])' for v in "ab"[:block.n_inputs]
           for j in range(NW)]
    lines.append("      : " + ", ".join(ins) + ");")
    lines.append("}")
    return "\n".join(lines)


def render():
    head = [
        "// GENERATED by gen_fp_asm.py (same directory): do not edit, run",
        "// the script. The BLS12-381 base field's product, square, sum and",
        "// difference on 12 little-endian 32-bit words, each ONE asm",
        "// statement of straight-line PTX with hardware carry chains; the",
        "// script's docstring explains the layout and the bounds, and",
        "// tests/test_torch_fp_product.py interprets this text on the CPU.",
        "// A function writes its outputs only after its last read of an",
        "// input, so an output may share a register with an input.",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace curdle {",
        ""]
    body = [render_function(name, gen(), what) + "\n"
            for name, gen, what in FUNCTIONS]
    return "\n".join(head + body + ["}  // namespace curdle", ""])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="fail if fp_asm.cuh differs from what would be "
                         "written")
    args = ap.parse_args()
    text = render()
    if args.check:
        if not OUT.exists() or OUT.read_text() != text:
            print(f"{OUT.name} is out of date: run gen_fp_asm.py",
                  file=sys.stderr)
            return 1
        return 0
    OUT.write_text(text)
    print(f"wrote {OUT} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
