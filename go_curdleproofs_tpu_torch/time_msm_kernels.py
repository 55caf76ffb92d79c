"""Device times of the two MSM kernels (windowed_combine, msm_select_reduce)
at the main paths' shapes, for comparing two checkouts on one card.

    python3 go_curdleproofs_tpu_torch/time_msm_kernels.py [--root CHECKOUT]
                                                          [--splits]

Needs one CUDA card (it fails without one). It imports the port from
CHECKOUT (default: the checkout this file is in), builds that checkout's
kernels if they are not built, and prints one line a shape: the kernel's
time in ms from CUDA events around 20 launches after a warm-up, with the
card's name and power limit first. It uses only the wrappers' public
arguments, so it also times a checkout from before the kernels were
redesigned: run it on the old checkout, the new, the new and the old again
inside one call, and compare.

--splits also sweeps the number of blocks that share one job's lanes in
msm_select_reduce (the wrapper's private `_split`), which is how the
wrapper's choice (`kernels._msm_split`) was made; it needs a checkout whose
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


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--splits", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    if not torch.cuda.is_available():
        print("time_msm_kernels: CUDA is not available", file=sys.stderr)
        return 2
    from go_curdleproofs_tpu_torch.ops import curve, kernels
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    dev = torch.device("cuda", 0)
    kernels.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{os.path.abspath(args.root)} on {card}")

    def kernel_ms(fn, launches=20):
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
