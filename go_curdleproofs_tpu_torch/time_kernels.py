"""Device times of the port's kernels at the main paths' shapes, for
comparing two checkouts on one card: mont_mul (B1), point_add (B2),
point_double (B3), point_x16_add (B4, both
load stages, and the window loop on it), windowed_combine (B5),
msm_select_reduce (B6), pow_fixed (B7), the batched point decode
decode_points, and the device prover's fr_pow_fixed (B8), fr_mont_mul,
strobe_absorb_stream and strobe_challenge32.

    python3 go_curdleproofs_tpu_torch/time_kernels.py [--root CHECKOUT]
                        [--splits] [--threads] [--point-threads]
                        [--mul-team] [--sass]

Needs one CUDA card (it fails without one). It imports the port from
CHECKOUT (default: the checkout this file is in), builds that checkout's
kernels if they are not built, and prints one line a shape: the kernel's
time in ms from CUDA events around 10-20 launches after a warm-up, with the
card's name and power limit first. It uses the wrappers' public arguments
wherever a checkout has them, so it also times a checkout from before a
kernel was redesigned: run it on the old checkout, the new, the new and the
old again inside one call, and compare. What an old checkout lacks (the
select stage of point_x16_add) is left out with a note.

A launch that ends before the host's next call reads the wrapper (its
ctypes call and torch.empty), not the card: mont_mul, point_add,
point_double and strobe_challenge32 are such launches at every shape of
the paths. So their lines also give the time a launch on the card, from
torch.profiler over the same launches (windowed_combine's and
msm_select_reduce's too: the profiler is read in a fresh process here,
while chip_smoke.py has used it up by its phase 8). strobe_challenge32 is
timed at
states whose challenge takes 1, 2 and 3 attempts; fr_mont_mul on the card
at the batches of the device prove's histogram (raw first operands, as
pairs and with one element broadcast on either side) and on 65,536
pairs.

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
warp leaves its scheduler idle. --point-threads builds the checkout's
pointwise.cu at 32, 64 and 128 threads a block of point_add and
point_double (its POINT_THREADS) into the build directory and times both
kernels of each build on the card at the paths' shapes, which is how the
block size of pointwise.cu was chosen. --mul-team builds pointwise.cu
with 1, 2 and 4 lanes a mont_mul element (its MUL_TEAM, at every batch
size: MUL_TEAM_MAX out of reach) and 32 and 128 threads a block
(MUL_THREADS), and times the multiply of each build on the card at the
paths' batches and on 65,536 pairs, which is how the team size, the
block and the batch above which one thread an element runs were
chosen. --sass counts the
instructions of every
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

# (jobs, lanes); (12, 1024) and (4, 1024) are msm_stacked_device at k=3,
# n=512 and m=4 and msm_rows_device there, rows 512 a fold at N=512
SHAPES_B6 = [(6, 256), (1, 256), (1, 2048), (12, 1024), (4, 1024)]
SHAPES_B6_SWEEP = [(1, 256), (3, 256), (6, 256), (1, 512), (1, 2048)]
ROWS_B5 = [1, 6, 7, 512, 2048]
SPLITS = (1, 2, 4, 8, 16)
# points a launch of B2 and B3 on the paths: the device prover's 1-24, the
# final MSM's 33, the table builds' [4, 1, 1024] and [1024]; 7 and 1025 are
# ragged
ADD_SHAPES = [(1,), (2,), (4,), (7,), (24,), (33,), (1025,), (4, 1, 1024)]
DOUBLE_SHAPES = [(1,), (4,), (24,), (1024,), (1025,)]
POINT_THREADS = (32, 64, 128)
# elements a launch of B1 on the paths (a histogram on the card: the
# device prover's 1-18 and 108, the host prover's 256-3,456, the
# verifier's 1,024 and 9,216) and the [9, 1, 2048] beta multiply, each
# times one element (chip_smoke.py checks the kernel at these); and both
# operands at 2048 and 65,536 (the stress)
MUL_SHAPES = [(1,), (2,), (3,), (4,), (6,), (9,), (10,), (18,), (108,),
              (256,), (1024,), (1152,), (2304,), (3456,), (9216,),
              (9, 1, 2048)]
MUL_PAIRS = [2048, 65536]
MUL_TEAMS = (1, 2, 4)
MUL_THREADS = (32, 128)
# elements a launch of fr_mont_mul in a device prove (chip_smoke.py's
# histogram at ELL=124: 1: 38 launches, 2: 12, 3-124: 22, 126-129: 30,
# 256: 39, 384: 1, 512: 14), as pairs and with one element broadcast on
# either side; and 65,536 pairs (the stress)
FR_MUL_SIZES = (1, 2, 3, 4, 8, 16, 32, 64, 98, 126, 128, 129, 256, 384, 512)
FR_MUL_PAIRS = 65536


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


def card_ms(fn, kernel, launches=20):
    """Device time a launch of `kernel` (its name in the profiler, e.g.
    point_add_kernel) in ms, from torch.profiler over `launches` calls
    after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and kernel in e.key]
    count = sum(e.count for e in hits)
    if count == 0:
        return float("nan")
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--threads", action="store_true")
    ap.add_argument("--point-threads", action="store_true")
    ap.add_argument("--mul-team", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        print("time_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from go_curdleproofs_tpu_torch.ops import curve, fp, glv, kernels
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
        on_card = sum(
            card_ms(lambda: kernels.msm_select_reduce(tab, dig), k)
            for k in ("msm_select_reduce_kernel", "msm_finish_kernel")[
                :1 + (kernels._msm_split(m, n2, W) > 1)])
        print(f"msm_select_reduce [9, {m}, {n2}]: {ms:.4f} ms; on the card "
              f"{on_card:.4f} ms a launch", flush=True)
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
        on_card = card_ms(lambda: kernels.windowed_combine(part),
                          "windowed_combine_kernel", 10)
        print(f"windowed_combine [{W}, {rows}]: {ms:.4f} ms; on the card "
              f"{on_card:.4f} ms a launch", flush=True)

    # B1: the beta multiply of a table's x plane, then every batch of the
    # paths on the card
    plane = fp.from_ints([rng.randrange(fh.P) for _ in range(9 * 2048)],
                         dev).reshape(9, 1, 2048, -1)
    beta = curve._beta_elem(dev)
    ms = kernel_ms(lambda: kernels.mont_mul(plane, beta))
    print(f"mont_mul [9, 1, 2048] x one element: {ms:.4f} ms", flush=True)
    mul_ops = mul_inputs(dev, rng)
    for (shape, what), (a, b) in mul_ops.items():
        on_card = card_ms(lambda: kernels.mont_mul(a, b), "mont_mul_kernel")
        print(f"mont_mul {list(shape)}{what}: on the card {on_card:.4f} ms "
              f"a launch", flush=True)
    if args.mul_team:
        sweep_mul_team(kernels, mul_ops)

    # B7: the sqrt ladder at the old decoder's 1024 lanes, the provers'
    # inverse ladders
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

    # the batched point decode at a prove's, the two verify cells' and a
    # 32-proof batch's points (any x below p: every x takes the same path)
    if hasattr(kernels, "decode_points"):
        for n in (248, 585, 2141, 18720):
            xb = torch.tensor([list(rng.randrange(fh.P).to_bytes(48, "big"))
                               for _ in range(n)], dtype=torch.uint8,
                              device=dev)
            wl = torch.zeros(n, dtype=torch.uint8, device=dev)
            ms = kernel_ms(lambda: kernels.decode_points(xb, wl), 5)
            on_card = card_ms(lambda: kernels.decode_points(xb, wl),
                              "decode_points_kernel", 5)
            print(f"decode_points [{n}]: {ms:.4f} ms, on the card "
                  f"{on_card:.4f} ms a launch", flush=True)
    else:
        print("decode_points: not in this checkout")

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
        dg = torch.from_numpy(glv.scalars_to_digits_glv(
            [rng.randrange(fh.R) for _ in range(n)])).to(dev)
        cells = [format(kernel_ms(lambda: f(pv, dg), 5), ".3f")
                 for f in (curve.scalar_mul_steps, curve.scalar_mul_device)]
        print(f"scalar multiplication of {n} point(s): window loop "
              f"{cells[0]} ms, one windowed_combine launch {cells[1]} ms",
              flush=True)

    point_ops = point_inputs(dev, pts)
    time_point_ops(kernels, point_ops)
    if args.point_threads:
        sweep_point_threads(kernels, point_ops)
    device_prover_kernels(kernels, dev, rng)
    fr_ops = fr_mul_inputs(dev, rng)
    for (n, what), (a, b) in fr_ops.items():
        on_card = card_ms(lambda: kernels.fr_mont_mul(a, b),
                          "fr_mont_mul_kernel")
        print(f"fr_mont_mul [{n}]{what}: on the card {on_card:.5f} ms a "
              f"launch", flush=True)
    if args.sass:
        sass_counts(kernels)
    return 0


def point_inputs(dev, pts):
    """{("add" | "double", shape): tuple of PointVecs} for B2 and B3: P
    from 1,025 distinct points, Q the same row rolled by 17."""
    import torch
    from go_curdleproofs_tpu_torch.ops import curve
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    row = curve.from_affine_host(pts + [fh.g1_add(pts[0], pts[-1])],
                                 device=dev)                     # 1025
    out = {}
    for kind, shapes in (("add", ADD_SHAPES), ("double", DOUBLE_SHAPES)):
        for shape in shapes:
            n = 1
            for d in shape:
                n *= d

            def take(v, shift):
                return curve.pmap(lambda t: torch.cat(
                    [t.roll(shift, 0)] * (n // 1025 + 1))[:n].reshape(
                        *shape, t.shape[-1]).contiguous(), v)
            out[kind, shape] = ((take(row, 0), take(row, 17))
                                if kind == "add" else (take(row, 0),))
    return out


def mul_inputs(dev, rng):
    """{(shape, what): (a, b)} for B1: MUL_SHAPES times one element, and
    MUL_PAIRS of random pairs."""
    from go_curdleproofs_tpu_torch.ops import fp
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    xs = fp.from_ints([rng.randrange(fh.P) for _ in range(65536)], dev)
    out = {}
    for shape in MUL_SHAPES:
        n = 1
        for d in shape:
            n *= d
        out[shape, " x one element"] = (
            xs[:n].reshape(*shape, xs.shape[-1]).contiguous(),
            xs[-1].contiguous())
    for n in MUL_PAIRS:
        out[(n,), " pairs"] = (xs[:n].contiguous(),
                               xs.flip(0)[:n].contiguous())
    return out


def fr_mul_inputs(dev, rng):
    """{(elements, what): (a, b)} for fr_mont_mul: FR_MUL_SIZES as pairs
    (raw first operands) and times one element, and FR_MUL_PAIRS pairs."""
    import torch
    from go_curdleproofs_tpu_torch.ops import fr
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    raw = torch.tensor([[w - (1 << 32) if w >> 31 else w for w in (
        (v >> (32 * j)) & 0xffffffff for j in range(fr.NWORDS))]
        for v in (rng.randrange(1 << 256) for _ in range(FR_MUL_PAIRS))],
        dtype=torch.int32).to(dev)
    ys = fr.from_ints([rng.randrange(fh.R) for _ in range(FR_MUL_PAIRS)],
                      dev)
    out = {}
    for n in FR_MUL_SIZES:
        out[n, " pairs"] = (raw[:n].contiguous(), ys[:n].contiguous())
        out[n, " x one element"] = (raw[:n].contiguous(), ys[-1].contiguous())
        out[n, " one raw element x"] = (raw[-1].contiguous(),
                                        ys[:n].contiguous())
    out[FR_MUL_PAIRS, " pairs"] = (raw, ys)
    return out


def sweep_mul_team(kernels, mul_ops) -> None:
    """pointwise.cu built at each of MUL_TEAMS lanes an element, mont_mul
    of each build timed on the card."""
    import ctypes
    import torch

    src = kernels._CSRC / "pointwise.cu"
    if "MUL_TEAM" not in src.read_text():
        print("mul team: this checkout's pointwise.cu has no MUL_TEAM",
              flush=True)
        return
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for team in MUL_TEAMS:
        for th in MUL_THREADS:
            lib = kernels.BUILD_DIR / f"libcurdle_pointwise_m{team}_t{th}.so"
            jobs.append((f"{team}x{th}", lib, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DMUL_TEAM={team}",
                 f"-DMUL_THREADS={th}", f"-DMUL_TEAM_MAX={1 << 40}", "-o",
                 str(lib), str(src)],
                stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launchers = {}
    for team, lib, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc for {team} lanes x threads failed")
        fn = ctypes.CDLL(str(lib)).curdle_mont_mul
        fn.argtypes = [vp, vp, vp, i64, i32, i32, vp]
        launchers[team] = fn
    stream = torch.cuda.current_stream().cuda_stream
    for (shape, what), (a, b) in mul_ops.items():
        out = torch.empty_like(a)
        n = a.numel() // a.shape[-1]
        cells = []
        for team, fn in launchers.items():
            def launch():
                if fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, 1,
                      int(b.shape == a.shape), stream) != 0:
                    raise RuntimeError(f"mont_mul at {team} lanes an "
                                       f"element: launch refused")
            ms = card_ms(launch, "mont_mul_kernel")
            cells.append(f"{team}: {ms:.4f}")
        print(f"mont_mul {list(shape)}{what} on the card, ms a launch by "
              f"lanes an element x threads a block: " + ", ".join(cells),
              flush=True)


def time_point_ops(kernels, point_ops) -> None:
    """B2 and B3 at the paths' shapes: CUDA events around 20 wrapper calls,
    and the time a launch on the card from the profiler."""
    for (kind, shape), args in point_ops.items():
        name = "point_" + kind
        fn = getattr(kernels, name)
        ms = kernel_ms(lambda: fn(*args))
        on_card = card_ms(lambda: fn(*args), name + "_kernel")
        print(f"{name} {list(shape)}: {ms:.4f} ms, on the card "
              f"{on_card:.4f} ms a launch", flush=True)


def sweep_point_threads(kernels, point_ops) -> None:
    """pointwise.cu built at each of POINT_THREADS threads a block, point_add
    and point_double of each build timed on the card."""
    import ctypes
    import torch

    src = kernels._CSRC / "pointwise.cu"
    if "POINT_THREADS" not in src.read_text():
        print("point threads: this checkout's pointwise.cu has no "
              "POINT_THREADS", flush=True)
        return
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for th in POINT_THREADS:
        lib = kernels.BUILD_DIR / f"libcurdle_pointwise_t{th}.so"
        jobs.append((th, lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DPOINT_THREADS={th}",
             "-o", str(lib), str(src)], stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT)))
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    launchers = {}
    for th, lib, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc -DPOINT_THREADS={th} failed")
        cdll = ctypes.CDLL(str(lib))
        add, dbl = cdll.curdle_point_add, cdll.curdle_point_double
        add.argtypes = [vp] * 9 + [i64, vp]
        dbl.argtypes = [vp] * 6 + [i64, vp]
        launchers[th] = dict(add=add, double=dbl)
    stream = torch.cuda.current_stream().cuda_stream
    for (kind, shape), args in point_ops.items():
        coords = [t for pt in args for t in pt]
        out = [torch.empty_like(coords[0]) for _ in range(3)]
        n = coords[0].numel() // coords[0].shape[-1]
        ptrs = [t.data_ptr() for t in coords + out]
        cells = []
        for th in POINT_THREADS:
            fn = launchers[th][kind]

            def launch():
                if fn(*ptrs, n, stream) != 0:
                    raise RuntimeError(f"point_{kind} at {th} threads a "
                                       f"block: launch refused")
            ms = card_ms(launch, f"point_{kind}_kernel")
            cells.append(f"{th}: {ms:.4f}")
        print(f"point_{kind} {list(shape)} on the card, ms a launch by "
              f"threads a block: " + ", ".join(cells), flush=True)


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
    from go_curdleproofs_tpu_torch.utils.transcript import Transcript
    label, pb, found = b"ipa_gamma", 3, {}
    while len(found) < 3:              # states that take 1, 2, 3 attempts
        st = bytes(rng.randrange(256) for _ in range(200))
        t = Transcript(b"time_kernels")
        t.inner.strobe.state[:] = st
        t.inner.strobe.pos, t.inner.strobe.pos_begin = pos, pb
        n_att = 1
        while int.from_bytes(t.inner.challenge_bytes(label, 32),
                             "big") >= fh.R:
            n_att += 1
        if n_att <= 3:
            found.setdefault(n_att, st)
    for n_att, st in sorted(found.items()):
        state = torch.tensor(list(st), dtype=torch.uint8, device=dev)
        ms = kernel_ms(lambda: kernels.strobe_challenge32(state, label, pos,
                                                          pb))
        on_card = card_ms(lambda: kernels.strobe_challenge32(
            state, label, pos, pb), "strobe_challenge32_kernel")
        print(f"strobe_challenge32 from position {pos}, {n_att} attempts: "
              f"{ms:.4f} ms, on the card {on_card:.4f} ms a launch",
              flush=True)


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
                # the longest kernel name in the mangled one, with a
                # template's arguments; a device function that is not
                # inlined keeps its mangled name
                hits = [n + "_kernel" for n in names if n + "_kernel" in line]
                args = re.search(r"_kernelI(\w+?)EEv", line)
                name = (hits[-1] + (f"<{args.group(1)}>" if args else "")
                        if hits else line.split(":", 1)[1].strip())
                counts[name] = [0, 0]
            elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
                counts[name][0] += 1
                counts[name][1] += "IMAD.WIDE" in line
        for name, (n, wide) in counts.items():
            print(f"{lib.name} {name}: {n} SASS instructions, "
                  f"{wide} of them IMAD.WIDE")


if __name__ == "__main__":
    sys.exit(main())
