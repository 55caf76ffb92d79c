"""Device times of the port's kernels at the main paths' shapes, for
comparing two checkouts on one card: mont_mul (B1), point_x16_add (B4, both
load stages, and the window loop on it), windowed_combine (B5),
msm_select_reduce (B6), pow_fixed (B7), and the device prover's
fr_pow_fixed (B8), fr_mont_mul, strobe_absorb_stream and
strobe_challenge32.

    python3 go_curdleproofs_tpu_torch/time_kernels.py [--root CHECKOUT]
                                        [--splits] [--threads] [--sass]

Needs one CUDA card (it fails without one). It imports the port from
CHECKOUT (default: the checkout this file is in), builds that checkout's
kernels if they are not built, and prints one line a shape: the kernel's
time in ms from CUDA events around 10-20 launches after a warm-up, with the
card's name and power limit first. It uses the wrappers' public arguments
wherever a checkout has them, so it also times a checkout from before a
kernel was redesigned: run it on the old checkout, the new, the new and the
old again inside one call, and compare. What an old checkout lacks (the
select stage of point_x16_add) is left out with a note.

The lone-warp times of one Fp product and one square are read from
pow_fixed on one element: exponent 2^380 is squarings only, 2^384 - 1 adds
a product to every nibble (or, one bit a step, to every bit), exponent 1
is the launch and whatever a ladder does before its first step. A launch
that ends before the host's next call reads the wrapper, not the card, so
the square is also read between two long chains, 2^192 and 2^380 (188
squarings). The Fr product and square are read the same way from
fr_pow_fixed: 2^128 (128 squarings), 2^252 (124 more), 2^256 - 1 (63 more
products).

--splits also sweeps the number of blocks that share one job's lanes in
msm_select_reduce (the wrapper's private `_split`), which is how the
wrapper's choice (`kernels._msm_split`) was made. --threads sweeps
pow_fixed's threads a block (the wrapper's private `_threads`) and fills
the card with one and with two blocks an SM, which shows whether a lone
warp leaves its scheduler idle. --sass counts the instructions of every
kernel in the built libraries with cuobjdump (fr_mont_mul_kernel is one Fr
product with its loads and stores). Each needs a checkout whose
wrapper has that argument.

Inputs are made from a fixed seed: distinct subgroup points, uniform digits
in [-8, 8]. Nothing is compared here; chip_smoke.py holds the kernels
against their plain versions.
"""

import argparse
import os
import random
import subprocess
import sys

SHAPES_B6 = [(6, 256), (1, 256), (1, 2048)]         # (jobs, lanes)
SHAPES_B6_SWEEP = [(1, 256), (3, 256), (6, 256), (1, 512), (1, 2048)]
ROWS_B5 = [1, 6, 7, 2048]
SPLITS = (1, 2, 4, 8, 16)


def kernel_ms(fn, launches=20):
    """Device time of one fn() in ms: CUDA events around `launches` calls
    after a warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--threads", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from go_curdleproofs_tpu_torch.ops import curve, fp, kernels
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    dev = torch.device("cuda", 0)
    kernels.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{os.path.abspath(args.root)} on {card}")

    rng = random.Random(2024)
    gen = torch.Generator().manual_seed(2024)
    W = curve.NUM_WINDOWS
    p = fh.g1_mul(fh.G1_GEN, rng.randrange(1, fh.R))
    step = fh.g1_mul(fh.G1_GEN, rng.randrange(1, fh.R))
    pts = []
    for _ in range(1024):
        pts.append(p)
        p = fh.g1_add(p, step)
    table = curve.StackedVec.from_affine([pts], device=dev,
                                         pad_to=1024).table()   # [9, 1, 2048]

    def msm_inputs(m, n2):
        tab = curve.pmap(lambda t: t[:, :, :n2].expand(
            9, m, n2, t.shape[-1]).contiguous(), table)
        dig = torch.randint(-8, 9, (m, n2, W), generator=gen,
                            dtype=torch.int32).to(dev)
        return tab, dig

    for m, n2 in SHAPES_B6:
        tab, dig = msm_inputs(m, n2)
        ms = kernel_ms(lambda: kernels.msm_select_reduce(tab, dig))
        print(f"msm_select_reduce [9, {m}, {n2}]: {ms:.4f} ms", flush=True)
    if args.splits:
        for m, n2 in SHAPES_B6_SWEEP:
            tab, dig = msm_inputs(m, n2)
            cells = [f"{s}: " + format(kernel_ms(
                lambda: kernels.msm_select_reduce(tab, dig, _split=s)), ".4f")
                for s in SPLITS if n2 // s >= 32]
            print(f"msm_select_reduce [9, {m}, {n2}] ms by split "
                  f"(the wrapper takes {kernels._msm_split(m, n2, W)}): "
                  + ", ".join(cells), flush=True)

    dig = torch.randint(-8, 9, (2048, W), generator=gen,
                        dtype=torch.int32).to(dev)
    sel = curve.table_select_windows(curve.pmap(lambda t: t[:, 0], table),
                                     dig)                      # [33, 2048]
    for rows in ROWS_B5:
        part = curve.pmap(lambda t: t[:, :rows].contiguous(), sel)
        ms = kernel_ms(lambda: kernels.windowed_combine(part), 10)
        print(f"windowed_combine [{W}, {rows}]: {ms:.4f} ms", flush=True)

    # B1: the beta multiply of a table's x plane
    plane = fp.from_ints([rng.randrange(fh.P) for _ in range(9 * 2048)],
                         dev).reshape(9, 1, 2048, -1)
    beta = curve._beta_elem(dev)
    ms = kernel_ms(lambda: kernels.mont_mul(plane, beta))
    print(f"mont_mul [9, 1, 2048] x one element: {ms:.4f} ms", flush=True)

    # B7: the decoder's sqrt ladder, the provers' inverse ladders
    x = fp.from_ints([rng.randrange(fh.P) for _ in range(1024)], dev)
    for n, e, what in ((1024, (fh.P + 1) // 4, "sqrt"),
                       (256, fh.P - 2, "inverse"), (24, fh.P - 2, "inverse"),
                       (1, fh.P - 2, "inverse")):
        part = x[:n].contiguous()
        ms = kernel_ms(lambda: kernels.pow_fixed(part, e), 10)
        print(f"pow_fixed [{n}] {what}: {ms:.4f} ms", flush=True)
    one = x[:1].contiguous()
    t_1, t_192, t_sq, t_all = (
        kernel_ms(lambda: kernels.pow_fixed(one, e), 10)
        for e in (1, 1 << 192, 1 << 380, (1 << 384) - 1))
    print(f"pow_fixed [1]: exponent 1 {t_1:.4f} ms, 2^192 {t_192:.4f} ms, "
          f"2^380 {t_sq:.4f} ms, 2^384-1 {t_all:.4f} ms", flush=True)
    if hasattr(kernels, "point_x16_add_select"):    # the 4-bit window
        print(f"lone warp: product {(t_all - t_sq) / 95 * 1e3:.3f} us (95 "
              f"more products), square {(t_sq - t_1) / 380 * 1e3:.3f} us "
              f"(380 more squarings), {(t_sq - t_192) / 188 * 1e3:.3f} us "
              f"between 2^192 and 2^380")
    else:                                           # one bit a step
        print(f"lone warp: product {(t_sq - t_1) / 380 * 1e3:.3f} us (380 "
              f"more products used as squarings; 2^384-1 adds 386: "
              f"{(t_all - t_sq) / 386 * 1e3:.3f} us)")
    if args.threads:
        big = fp.from_ints([rng.randrange(fh.P) for _ in range(1024)],
                           dev).repeat(33, 1)                  # 264 * 128
        e = (fh.P + 1) // 4
        for th in (32, 64, 128):
            cells = [format(kernel_ms(lambda: kernels.pow_fixed(
                x[:n].contiguous(), e, _threads=th), 10), ".4f")
                for n in (1024, 256)]
            print(f"pow_fixed sqrt at {th} threads a block: [1024] "
                  f"{cells[0]} ms, [256] {cells[1]} ms", flush=True)
        for blocks in (132, 264):
            part = big[:blocks * 128].contiguous()
            ms = kernel_ms(lambda: kernels.pow_fixed(part, e, _threads=128),
                           5)
            print(f"pow_fixed sqrt [{blocks * 128}] at 128 threads: "
                  f"{blocks} blocks on 132 SMs, {ms:.4f} ms", flush=True)

    # B4: the step at the window loop's batches, and the loop itself
    for n in (2, 4, 24):
        acc = curve.pmap(lambda t: t[0, :n].contiguous(), sel)
        opd = curve.pmap(lambda t: t[1, :n].contiguous(), sel)
        ms = kernel_ms(lambda: kernels.point_x16_add(acc, opd))
        line = f"point_x16_add [{n}]: operand given {ms:.4f} ms"
        if hasattr(kernels, "point_x16_add_select"):
            tab = curve.pmap(lambda t: t[:, 0, :n].contiguous(), table)
            dg = dig[:n].contiguous()
            ms = kernel_ms(lambda: kernels.point_x16_add_select(
                acc, tab, dg, 3, out=acc))
            line += f", operand selected, in place {ms:.4f} ms"
        else:
            line += " (this checkout has no select stage)"
        print(line, flush=True)
    for n in (1, 2, 12):
        pv = curve.from_affine_host(pts[:n], device=dev)
        dg = curve._digits(curve.scalars_to_digits(
            [rng.randrange(fh.R) for _ in range(n)]), dev)
        cells = [format(kernel_ms(lambda: f(pv, dg), 5), ".3f")
                 for f in (curve.scalar_mul_steps, curve.scalar_mul_device)]
        print(f"scalar multiplication of {n} point(s): window loop "
              f"{cells[0]} ms, one windowed_combine launch {cells[1]} ms",
              flush=True)

    device_prover_kernels(kernels, dev, rng)
    if args.sass:
        sass_counts(kernels)
    return 0


def device_prover_kernels(kernels, dev, rng) -> None:
    """B8 at the device prover's batches, the lone-warp Fr product and
    square, fr_mont_mul, and the transcript kernels at the same-multiscalar
    step's stream ([256 x 48] from position 41: 108 permutations)."""
    import torch
    from go_curdleproofs_tpu_torch.ops import fr
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    x = fr.from_ints([rng.randrange(fh.R) for _ in range(128)], dev)
    for n in (8, 1):
        part = x[:n].contiguous()
        ms = kernel_ms(lambda: kernels.fr_pow_fixed(part, fh.R - 2))
        print(f"fr_pow_fixed [{n}] exponent r-2: {ms:.4f} ms", flush=True)
    one = x[:1].contiguous()
    t_1, t_128, t_sq, t_all = (
        kernel_ms(lambda: kernels.fr_pow_fixed(one, e), 10)
        for e in (1, 1 << 128, 1 << 252, (1 << 256) - 1))
    print(f"fr_pow_fixed [1]: exponent 1 {t_1:.4f} ms, 2^128 {t_128:.4f} ms, "
          f"2^252 {t_sq:.4f} ms, 2^256-1 {t_all:.4f} ms", flush=True)
    if "fr_asm.cuh" in kernels._SOURCES:               # the 4-bit window
        print(f"lone warp, Fr: product {(t_all - t_sq) / 63 * 1e3:.3f} us "
              f"(63 more products), square "
              f"{(t_sq - t_128) / 124 * 1e3:.3f} us (124 more squarings)")
    else:                                              # one bit a step
        print(f"lone warp, Fr: product {(t_sq - t_128) / 124 * 1e3:.3f} us "
              f"(124 more products used as squarings)")
    y = x.flip(0).contiguous()
    ms = kernel_ms(lambda: kernels.fr_mont_mul(x, y))
    print(f"fr_mont_mul [128]: {ms:.4f} ms", flush=True)

    gen = torch.Generator().manual_seed(2026)
    state = torch.randint(0, 256, (200,), generator=gen,
                          dtype=torch.uint8).to(dev)
    pos, n = 41, 256 * 48 + 256 * 22     # rows with their message headers
    stream = torch.randint(0, 256, (n,), generator=gen,
                           dtype=torch.uint8).to(dev)
    pbs = torch.randint(0, 167, ((pos + n) // kernels.STROBE_R,),
                        generator=gen, dtype=torch.uint8).to(dev)
    ms = kernel_ms(lambda: kernels.strobe_absorb_stream(state, stream, pos,
                                                        pbs), 10)
    print(f"strobe_absorb_stream {n} bytes from position {pos}: {ms:.4f} ms, "
          f"{pbs.numel()} permutations, {ms / pbs.numel() * 1e3:.3f} us a "
          f"permutation", flush=True)
    ms = kernel_ms(lambda: kernels.strobe_challenge32(state, b"ipa_gamma",
                                                      pos, 3))
    print(f"strobe_challenge32 from position {pos}: {ms:.4f} ms", flush=True)


def sass_counts(kernels) -> None:
    """Instructions per kernel of the built CUDA libraries (cuobjdump
    -sass); mont_mul_kernel is one product and its loads and stores."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    names = sorted(list(kernels.KERNEL_NAMES) + ["msm_finish"], key=len)
    for lib in kernels.build().values():
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, check=True).stdout
        name, counts = None, {}
        for line in out.splitlines():
            if "Function :" in line:
                # the longest kernel name in the mangled one; a device
                # function that is not inlined keeps its mangled name
                hits = [n + "_kernel" for n in names if n + "_kernel" in line]
                name = hits[-1] if hits else line.split(":", 1)[1].strip()
                counts[name] = [0, 0]
            elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
                counts[name][0] += 1
                counts[name][1] += "IMAD.WIDE" in line
        for name, (n, wide) in counts.items():
            print(f"{lib.name} {name}: {n} SASS instructions, "
                  f"{wide} of them IMAD.WIDE")


if __name__ == "__main__":
    sys.exit(main())
