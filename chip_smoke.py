#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port (go_curdleproofs_tpu_torch) on the card:

  1. environment: versions, the card, its power limit, whether the host C
     library or the Python path serves the transcript;
  2. build: compiles the CUDA kernels from ops/csrc/ with nvcc (one process
     per source, started together) and the host C library with cc;
  3. each of the eleven kernels against its plain torch version on the card,
     at the shapes the verifier and the provers give it, compared exactly by
     value (integers, tolerance 0), with timings and roofline bounds;
     windowed_combine and msm_select_reduce also at ragged shapes, at a
     forced split, and at inputs that hit the corners of the complete
     point formulas, each time beside the time of the previous design;
     the Fp product on 65,536 pairs (every pair of ~45 edge elements, then
     random ones) and the dedicated square against the product; pow_fixed
     at awkward exponents, with the lone-warp time of one product and one
     square read from its chain; both load stages of point_x16_add with
     every digit on an infinity row and a finite row; the two forms of a
     per-point scalar multiplication (the window loop on point_x16_add,
     the one-launch windowed_combine) side by side;
  4. verifier path: ELL=124 CRS, both proofs of
     tests/fixture_whisk_ell124.json verified with launch counts, tampered
     proofs rejected, the golden ell=12 Whisk proof and tracker proof
     accepted, cold/warm verify times;
  5. prover path: the golden ell=12 Whisk proof, the golden ell=12 and
     ell=60 shuffle proofs and the golden tracker proof regenerated from
     their seeds and compared byte for byte with tests/golden_vectors.json;
     then a proof at ELL=124 from the fixture's trackers, verified by the
     port's verifier, a flipped byte rejected, cold/warm prove times and
     launch counts per prove and per verify;
  6. device prover path: the golden ell=12 and ell=60 shuffle proofs and
     the golden ell=12 Whisk proof reproduced byte for byte with
     prover="device"; an ELL=124 prove with prover="device" byte-identical
     to the prover="host" proof from the same seeds, verified, a flipped
     byte rejected; the chain between upload and the one fetch run under
     torch.cuda.set_sync_debug_mode("error"), so any synchronising call in
     it fails the run; launch counts of every kernel over that prove
     (point_x16_add exactly 363: 11 window loops of 33 launches);
     cold/warm times of both provers side by side; strobe_absorb_stream
     exactly 28 and strobe_challenge32 exactly 22 launches a device prove.

The device prover's kernels (phase 3) are held at the shapes of that path
and at their corners: the Fr product on 65,536 pairs (every pair of ~40
edge elements and of raw first operands up to 2^256 - 1, then random
ones) against the plain version and Python ints, the square against the
product; fr_pow_fixed at [8] and [1] with exponent r - 2 and at awkward
exponents, with the lone-warp time of one Fr product and one square;
strobe_absorb_stream at every start position and length that meets an
edge of the warp's lane words or of the rate, with and without the forced
permutation, against the plain version and the host STROBE.

Prints the kernel summary as one JSON line, then as the last line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
non-zero and no result line is printed. Without CUDA it exits non-zero.
Imports neither jax nor the JAX package.
"""

import hashlib
import io
import json
import os
import platform
import random
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

CSRC = "go_curdleproofs_tpu_torch/ops/csrc/"
REPLACES = {
    "mont_mul": "go_curdleproofs_tpu/ops/rns_kernels.py:642",
    "point_add": "go_curdleproofs_tpu/ops/rns_kernels.py:366",
    "point_double": "go_curdleproofs_tpu/ops/rns_kernels.py:382",
    "pow_fixed": "go_curdleproofs_tpu/ops/rns_kernels.py:664",
    "windowed_combine": "go_curdleproofs_tpu/ops/rns_kernels.py:421",
    "msm_select_reduce": "go_curdleproofs_tpu/ops/rns_kernels.py:500",
    "point_x16_add": "go_curdleproofs_tpu/ops/rns_kernels.py:397",
    "fr_pow_fixed": "go_curdleproofs_tpu/ops/limb_kernels.py:65",
    # the port's own kernels: no TPU kernel stands behind them, these are
    # the array-op functions of the JAX package whose work they do
    "fr_mont_mul": "go_curdleproofs_tpu/ops/limb_field.py:234",
    "strobe_absorb_stream": "go_curdleproofs_tpu/ops/strobe_dev.py:314",
    "strobe_challenge32": "go_curdleproofs_tpu/ops/strobe_dev.py:361",
}
# the kernels that the verifier and the host-orchestrated prover run; the
# device-resident prover runs all of REPLACES
EARLIER_KERNELS = ("mont_mul", "point_add", "point_double", "pow_fixed",
                   "windowed_combine", "msm_select_reduce")
FIXTURE = os.path.join(ROOT, "tests", "fixture_whisk_ell124.json")
GOLDEN = os.path.join(ROOT, "tests", "golden_vectors.json")
SMS_FLIP_BYTE = 4520      # inside the same-multiscalar scalar x (4504-4535)
PROVE_SEED = 0x5EED       # Rand seed of the ELL=124 prove
# (windowed_combine, msm_select_reduce) wrapper calls of one run at ELL=124:
# a redesign of the kernels must leave them as they are
MSM_LAUNCHES = {"verify": (2, 2), "prove": (23, 21), "device prove": (23, 21)}

# The card's peaks for the roofline bound (NVIDIA H100 SXM data sheet and
# Hopper white paper): 3.35e12 bytes/s of HBM3; 67e12 float32 FLOP/s outside
# the tensor cores = 33.5e12 multiply-adds/s on 128 FP32 lanes an SM, and an
# SM has 64 INT32 lanes, so half that for a 32-bit integer multiply-add.
HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 16.75e12
ELEM_BYTES = 48
MADS_PER_PRODUCT = 2 * 12 * 12        # product and Montgomery reduction
PRODUCTS_ADD, PRODUCTS_DOUBLE = 12, 8
FR_BYTES = 32
FR_MADS_PER_PRODUCT = 2 * 8 * 8       # 8-word product and reduction
# Keccak-f[1600]: 24 rounds of ~150 64-bit xor/and/not/rotate operations,
# two 32-bit integer operations each
KECCAK_INT32_OPS = 24 * 150 * 2

# Kernel ms of the previous design of a redesigned kernel, from this script
# at the commit before its redesign on an NVIDIA H100 80GB HBM3, 700.00 W:
# printed beside the new times. windowed_combine: one thread a row;
# msm_select_reduce: one block of 128 threads a (window, job) (both commit
# f0bd51a). pow_fixed: one bit a step on the 64-bit C product;
# point_x16_add: one thread a point, 44 products deep (both commit c3c7562).
# fr_pow_fixed: one bit a step on the 64-bit C product; strobe_absorb_stream:
# one thread permutes out of shared memory (both commit 9fb31f6).
PREVIOUS_DESIGN_MS = {
    "fr_pow_fixed [1] exponent r-2": 0.2807,
    "strobe_absorb_stream [256 x 48]": 1.5394,
    "windowed_combine [33, 1]": 5.5717,
    "windowed_combine [33, 6]": 5.5730,
    "windowed_combine [33, 2048]": 5.8333,
    "msm_select_reduce [9, 6, 256]": 0.4743,
    "msm_select_reduce [9, 1, 256]": 0.4664,
    "msm_select_reduce [9, 1, 2048]": 1.2082,
    "pow_fixed [1024] sqrt exponent": 0.9242,
    "pow_fixed [256] inverse exponent": 0.9313,
    "point_x16_add [24]": 0.1675,
    "point_x16_add [2]": 0.1669,
}
MADS_PER_SQUARE = 12 * 13 // 2 + 12 * 12   # 78 partial products, reduction
FR_MADS_PER_SQUARE = 8 * 9 // 2 + 8 * 8    # 36 partial products, reduction
# launches of one ELL=124 device prove that a redesign must leave as they are
DEVICE_PROVE_LAUNCHES = {"fr_pow_fixed": 17, "point_x16_add": 363,
                         "strobe_absorb_stream": 28,
                         "strobe_challenge32": 22}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def check_msm_launches(counts: dict, run: str) -> None:
    got = (counts["windowed_combine"], counts["msm_select_reduce"])
    check(got == MSM_LAUNCHES[run],
          f"(windowed_combine, msm_select_reduce) launches per {run}: "
          f"{got}, expected {MSM_LAUNCHES[run]}")


def cuda_ms(fn, reps: int = 3) -> float:
    """Median wall time of fn() in ms, synchronised before and after."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernel_ms(fn, launches: int = 20) -> float:
    """Device time of one fn() in ms: CUDA events around `launches` calls
    after a warm-up call."""
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


def bound(n_bytes: float, products: float,
          ops_per_product: int = MADS_PER_PRODUCT) -> dict:
    """The least time the card could take: bytes over the memory rate
    against 32-bit integer operations (multiply-adds of `products` field
    products, or plain integer operations) over the int32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = products * ops_per_product / INT32_MADS_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def phase_env(dev: torch.device) -> str:
    from go_curdleproofs_tpu_torch.utils import keccak, strobe

    print(f"python {platform.python_version()}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    name = torch.cuda.get_device_name(dev)
    print(f"device {name}  count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"host transcript: strobe bulk native {strobe.has_native_bulk()}, "
          f"keccak native {keccak.has_native()} "
          f"(False: the Python path is in use)")
    return card


def phase_build() -> None:
    from go_curdleproofs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print((kernels.BUILD_DIR / "nvcc.log").read_text().strip())


def _curve_points(n: int, rng: random.Random):
    """n distinct subgroup points: an arithmetic progression a*G + i*b*G."""
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    p = fh.g1_mul(fh.G1_GEN, rng.randrange(1, fh.R))
    step = fh.g1_mul(fh.G1_GEN, rng.randrange(1, fh.R))
    out = []
    for _ in range(n):
        out.append(p)
        p = fh.g1_add(p, step)
    return out


def _affine_err(a, b) -> int:
    """Max |difference| of canonical affine coordinates (0 when equal)."""
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    err = 0
    for pa, pb in zip(a, b):
        if pa is None or pb is None:
            err = max(err, 0 if pa == pb else fh.P)
        else:
            err = max(err, abs(pa[0] - pb[0]), abs(pa[1] - pb[1]))
    return err


def _point_err(got, want) -> int:
    """0 when two PointVecs hold the same words; else the affine error."""
    from go_curdleproofs_tpu_torch.ops import curve

    if all(torch.equal(a, b) for a, b in zip(got, want)):
        return 0
    return max(1, _affine_err(curve.to_affine_host(got),
                              curve.to_affine_host(want)))


def _rand_digits(shape, rng: random.Random) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return torch.tensor([rng.randint(-8, 8) for _ in range(n)],
                        dtype=torch.int32).reshape(shape)


def ladder_steps(e: int):
    """(squarings, products) of the 4-bit window ladder of pow_fixed and
    fr_pow_fixed for e."""
    nibbles = [(e >> (4 * i)) & 15 for i in range((e.bit_length() + 3) // 4)]
    return (7 + 4 * (len(nibbles) - 1),
            7 + sum(d != 0 for d in nibbles[:-1]))


def edge_elements(rng: random.Random):
    """Field elements on which a lost carry would show: the ends of the
    range, R and R^2, powers of two and their predecessors around word
    boundaries, and per word position one element with that word all
    zeros and one with it all ones."""
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    p = fh.P
    vals = [0, 1, 2, p - 1, p - 2, (p + 1) // 2, (1 << 384) % p,
            (1 << 768) % p, (1 << 380) - 1]
    for k in (31, 32, 33, 63, 64, 65, 191, 192, 351, 352, 380):
        vals += [1 << k, (1 << k) - 1]
    for j in range(12):
        for fill in (0, 0xFFFFFFFF):
            v = rng.randrange(p) & ~(0xFFFFFFFF << (32 * j))
            v |= fill << (32 * j)
            if v >= p:      # all ones in the top word: the largest below
                v = (((p >> 352) - 1) << 352) | ((1 << 352) - 1)
            vals.append(v)
    return vals


def fr_edge_elements(rng: random.Random):
    """Scalar-field values on which a lost carry would show (below r) and
    raw 32-byte words at or above r (first operands of the product only)."""
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    r, top = fh.R, 1 << 256
    vals = [0, 1, 2, r - 1, r - 2, (r + 1) // 2, top % r, top * top % r,
            (1 << 254) - 1]
    for k in (31, 32, 33, 63, 64, 127, 128, 223, 224):
        vals += [1 << k, (1 << k) - 1]
    for j in range(8):
        for fill in (0, 0xFFFFFFFF):
            v = rng.randrange(r) & ~(0xFFFFFFFF << (32 * j))
            v |= fill << (32 * j)
            if v >= r:      # all ones in the top word: the largest below
                v = (((r >> 224) - 1) << 224) | ((1 << 224) - 1)
            vals.append(v)
    raw = [top - 1, top - 2, r, r + 1, 2 * r - 1, 2 * r, top - r,
           (0xFFFFFFFF << 224) | 1, top - 1 - (1 << 224)]
    return vals, raw


def _raw_fr(vals, dev: torch.device) -> torch.Tensor:
    """[n, 8] int32 words of values below 2^256, taken as they are."""
    words = [[(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)] for v in vals]
    return torch.tensor([[w - (1 << 32) if w >> 31 else w for w in row]
                         for row in words], dtype=torch.int32, device=dev)


def _fr_values(t: torch.Tensor):
    """The integers that [n, 8] int32 words hold."""
    return [sum((w & 0xFFFFFFFF) << (32 * j) for j, w in enumerate(row))
            for row in t.tolist()]


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel vs its plain version on the card, at the main paths'
    shapes. Returns {name: {"max_abs_err", "ms", "plain_ms", "bound_ms",
    "bound_by"}} at the kernel's widest main-path shape."""
    from go_curdleproofs_tpu_torch.ops import curve, fp, kernels
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    rng = random.Random(2024)
    res = {}
    W = curve.NUM_WINDOWS
    print("kernel vs plain: exact integer results, tolerance 0")

    def report(name, shape, err, ms, plain_ms, bnd, keep=True, what=""):
        prev = None if what else PREVIOUS_DESIGN_MS.get(f"{name} {shape}")
        print(f"{name} {shape}{what}: exact; kernel {ms:.4f} ms"
              + (f" (previous design {prev:.4f} ms)" if prev else "")
              + f", plain {plain_ms:.2f} ms, bound {bnd['bound_ms']:.6f} ms "
              f"by {bnd['bound_by']}")
        if keep:
            res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd)

    # B1: the beta multiply of a table's x plane (one element against
    # [9, 1, 2048]) and the decoder's elementwise products ([2 * 1024])
    vals = [0, 1, fh.P - 1] + [rng.randrange(fh.P) for _ in range(2045)]
    a = fp.from_ints(vals, dev)
    b = fp.from_ints(vals[::-1], dev)
    got, want = kernels.mont_mul(a, b), kernels.mont_mul_plain(a, b)
    gi = fp.to_ints(got)
    check(torch.equal(got, want) and gi == [x * y % fh.P for x, y in
                                            zip(vals, vals[::-1])],
          "mont_mul [2048]")
    report("mont_mul", [2048], 0,
           kernel_ms(lambda: kernels.mont_mul(a, b)),
           cuda_ms(lambda: kernels.mont_mul_plain(a, b)),
           bound(3 * 2048 * ELEM_BYTES, 2048), keep=False)
    plane = fp.from_ints([rng.randrange(fh.P) for _ in range(9 * 2048)],
                         dev).reshape(9, 1, 2048, fp.NWORDS)
    beta = curve._beta_elem(dev)
    got, want = kernels.mont_mul(plane, beta), kernels.mont_mul_plain(plane,
                                                                      beta)
    check(torch.equal(got, want), "mont_mul [9,1,2048] x one element")
    n = 9 * 2048
    report("mont_mul", [9, 1, 2048], 0,
           kernel_ms(lambda: kernels.mont_mul(plane, beta)),
           cuda_ms(lambda: kernels.mont_mul_plain(plane, beta)),
           bound((2 * n + 1) * ELEM_BYTES, n))

    # the product's carry chains: every pair of the edge elements, word for
    # word against the plain version and Python ints, then random pairs up
    # to 65,536; the dedicated square (pow_fixed with exponent 2) against
    # the product on the same elements
    edge = edge_elements(rng)
    xs = [u for u in edge for _ in edge]
    ys = [v for _ in edge for v in edge]
    n_edge = len(xs)
    xs += [rng.randrange(fh.P) for _ in range(65536 - n_edge)]
    ys += [rng.randrange(fh.P) for _ in range(65536 - n_edge)]
    a, b = fp.from_ints(xs, dev), fp.from_ints(ys, dev)
    got = kernels.mont_mul(a, b)
    check(torch.equal(got, kernels.mont_mul_plain(a, b)),
          "mont_mul stress: 65,536 pairs against the plain version")
    check(fp.to_ints(got[:n_edge]) == [x * y % fh.P for x, y in
                                       zip(xs[:n_edge], ys[:n_edge])],
          "mont_mul stress: the edge grid against Python ints")
    check(torch.equal(kernels.pow_fixed(a, 2), kernels.mont_mul(a, a)),
          "pow_fixed(x, 2) == mont_mul(x, x): the square against the product")
    print(f"mont_mul stress: {len(edge)} edge elements, every pair "
          f"({n_edge}), and {65536 - n_edge} random pairs: exact; "
          f"pow_fixed(x, 2) == mont_mul(x, x) on all 65,536")

    # a 1024-point base row; its first lanes hold the edge cases
    pts = _curve_points(1024, rng)
    qts = _curve_points(1024, rng)
    pts[0] = None                              # infinity + Q
    qts[1] = None                              # P + infinity
    pts[2] = qts[2] = None                     # infinity + infinity
    qts[3] = pts[3]                            # P + P
    qts[4] = fh.g1_neg(pts[4])                 # P + (-P)
    pv = curve.from_affine_host(pts, device=dev)
    qv = curve.from_affine_host(qts, device=dev)

    # B3: the table build's double of the [1, 1024] row
    got, want = kernels.point_double(pv), kernels.point_double_plain(pv)
    err = _point_err(got, want)
    check(err == 0 and curve.to_affine_host(got)
          == [fh.g1_add(p, p) for p in pts], "point_double [1024]")
    report("point_double", [1024], err,
           kernel_ms(lambda: kernels.point_double(pv)),
           cuda_ms(lambda: kernels.point_double_plain(pv)),
           bound(6 * 1024 * ELEM_BYTES, 1024 * PRODUCTS_DOUBLE))

    # B2: the [33] window-sum add of the final MSM and the [4, 1, 1024]
    # table-build add
    got, want = kernels.point_add(pv, qv), kernels.point_add_plain(pv, qv)
    check(_point_err(got, want) == 0 and curve.to_affine_host(got)
          == [fh.g1_add(p, q) for p, q in zip(pts, qts)],
          "point_add edge cases")
    same = kernels.point_add(pv, pv)                       # aliased operands
    check(_point_err(same, kernels.point_add_plain(pv, pv)) == 0
          and curve.to_affine_host(same) == [fh.g1_add(p, p) for p in pts],
          "point_add(p, p)")
    p33 = curve.pmap(lambda t: t[:33].contiguous(), pv)
    q33 = curve.pmap(lambda t: t[:33].contiguous(), qv)
    got, want = kernels.point_add(p33, q33), kernels.point_add_plain(p33, q33)
    check(_point_err(got, want) == 0, "point_add [33]")
    report("point_add", [33], 0,
           kernel_ms(lambda: kernels.point_add(p33, q33)),
           cuda_ms(lambda: kernels.point_add_plain(p33, q33)),
           bound(9 * 33 * ELEM_BYTES, 33 * PRODUCTS_ADD), keep=False)
    p4 = curve.pmap(lambda t: t.expand(4, 1, 1024, fp.NWORDS).contiguous(),
                    pv)
    q4 = curve.pmap(lambda t: torch.stack(
        [t, t.roll(1, 0), t.roll(2, 0), t.roll(3, 0)])[:, None].contiguous(),
        qv)
    got, want = kernels.point_add(p4, q4), kernels.point_add_plain(p4, q4)
    err = _point_err(got, want)
    check(err == 0, "point_add [4,1,1024]")
    report("point_add", [4, 1, 1024], err,
           kernel_ms(lambda: kernels.point_add(p4, q4)),
           cuda_ms(lambda: kernels.point_add_plain(p4, q4)),
           bound(9 * 4096 * ELEM_BYTES, 4096 * PRODUCTS_ADD))

    # B7: the decode's sqrt ladder over the 1024-lane pool and the provers'
    # inverse ladders ([256], [24], [1]; exponent p - 2, with 0)
    for n, e, what in ((1024, (fh.P + 1) // 4, "sqrt"),
                       (256, fh.P - 2, "inverse"), (24, fh.P - 2, "inverse"),
                       (1, fh.P - 2, "inverse")):
        vals = ([rng.randrange(fh.P) for _ in range(n)]
                + [0, 1, fh.P - 1])[-n:]
        x = fp.from_ints(vals, dev)
        got, want = kernels.pow_fixed(x, e), kernels.pow_fixed_plain(x, e)
        gi, wi = fp.to_ints(got), fp.to_ints(want)
        err = max(abs(u - v) for u, v in zip(gi, wi))
        check(err == 0 and gi == [pow(v, e, fh.P) for v in vals],
              f"pow_fixed [{n}] {what}")
        n_sqr, n_mul = ladder_steps(e)
        report("pow_fixed", f"[{n}] {what} exponent", err,
               kernel_ms(lambda: kernels.pow_fixed(x, e), 5),
               cuda_ms(lambda: kernels.pow_fixed_plain(x, e), 1),
               bound(2 * n * ELEM_BYTES, n * (
                   n_mul + n_sqr * MADS_PER_SQUARE / MADS_PER_PRODUCT)),
               keep=n == 1024)
    # small and awkward exponents: below 16, zero nibbles, every bit length
    # mod 4, all ones
    vals = [0, 1, fh.P - 1] + [rng.randrange(fh.P) for _ in range(29)]
    x = fp.from_ints(vals, dev)
    for e in (1, 2, 3, 15, 16, 17, (1 << 384) - 1, 0x9000A00000B0000C0D,
              0x1F3, 0x2F03, 0x7000F, 1 << 380):
        got = kernels.pow_fixed(x, e)
        check(torch.equal(got, kernels.pow_fixed_plain(x, e))
              and fp.to_ints(got) == [pow(v, e, fh.P) for v in vals],
              f"pow_fixed exponent {e:#x}")
    print("pow_fixed at 12 small and awkward exponents: exact")
    # one product and one square of a lone warp, from the chain: 2^380 is
    # 387 squarings and 7 products, 2^384 - 1 adds 95 products, 1 has the
    # table's 7 and 7 only
    one = x[3:4].contiguous()
    t_1, t_sq, t_all = (kernel_ms(lambda: kernels.pow_fixed(one, e), 10)
                        for e in (1, 1 << 380, (1 << 384) - 1))
    print(f"lone warp, from pow_fixed [1] at exponents 1 / 2^380 / 2^384-1 "
          f"({t_1:.4f} / {t_sq:.4f} / {t_all:.4f} ms): one product "
          f"{(t_all - t_sq) / 95 * 1e3:.3f} us, one square "
          f"{(t_sq - t_1) / 380 * 1e3:.3f} us")

    def msm_bound(tab, dig):
        m, n2 = dig.shape[:2]
        n_bytes = (3 * 9 * m * n2 + 3 * m * W) * ELEM_BYTES + 4 * dig.numel()
        # a lane whose digit is zero selects infinity and needs no add
        return bound(n_bytes, int((dig != 0).sum()) * PRODUCTS_ADD)

    def check_msm(tab, dig, keep, split=None, what=""):
        """Two launches in a row (with a split the second finds the scratch
        and the grid as the first left them), then the plain version."""
        shape = [9, *dig.shape[:2]]
        got = kernels.msm_select_reduce(tab, dig, _split=split)
        again = kernels.msm_select_reduce(tab, dig, _split=split)
        torch.cuda.synchronize()
        want = kernels.msm_select_reduce_plain(tab, dig)
        got_aff = curve.to_affine_host(got)
        err = _affine_err(got_aff, curve.to_affine_host(want))
        check(err == 0, f"msm_select_reduce {shape}{what}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"msm_select_reduce {shape}{what}: a second launch repeats")
        report("msm_select_reduce", shape, err,
               kernel_ms(lambda: kernels.msm_select_reduce(tab, dig,
                                                           _split=split)),
               cuda_ms(lambda: kernels.msm_select_reduce_plain(tab, dig), 1),
               msm_bound(tab, dig), keep=keep, what=what)
        return got, got_aff

    def check_combine(sel, keep, what=""):
        shape = list(sel.x.shape[:2])
        got = kernels.windowed_combine(sel)
        torch.cuda.synchronize()
        want = kernels.windowed_combine_plain(sel)
        err = _point_err(got, want)
        check(err == 0, f"windowed_combine {shape}{what}")
        n_win, rows = shape
        report("windowed_combine", shape, err,
               kernel_ms(lambda: kernels.windowed_combine(sel), 10),
               cuda_ms(lambda: kernels.windowed_combine_plain(sel), 1),
               bound(3 * (n_win + 1) * rows * ELEM_BYTES, rows * n_win
                     * (4 * PRODUCTS_DOUBLE + PRODUCTS_ADD)), keep=keep,
               what=what)
        return got

    # B6 then B5 as a same-multiscalar round gives them: 6 terms over the
    # three-row [G, T, U] table [9, 3, 256]
    gtu = curve.StackedVec.from_affine(
        [pts[5:133], qts[5:133], pts[133:261]], device=dev, pad_to=128)
    tab6 = curve.pmap(lambda t: t.index_select(1, torch.tensor(
        [0, 1, 2, 0, 1, 2], device=dev)).contiguous(), gtu.table())
    dig6 = _rand_digits((6, 256, W), rng).to(dev)
    sums6, _ = check_msm(tab6, dig6, keep=False)
    check_combine(curve.pmap(lambda t: t.transpose(0, 1).contiguous(), sums6),
                  keep=False)

    # B6 off the even shapes: 200 lanes of three jobs over two and over
    # three blocks each (no multiple of 3, of a block's 32 groups or of a
    # group of 8), with one job whose digits are all zero: every window sum
    # of it is infinity
    tab3 = curve.pmap(lambda t: t[:, :3, :200].contiguous(), gtu.table())
    dig3 = _rand_digits((3, 200, W), rng)
    dig3[1] = 0
    for split in (2, 3):
        _, aff3 = check_msm(tab3, dig3.to(dev), keep=False, split=split,
                            what=f" split {split}, one job all zero")
        check(aff3[W:2 * W] == [None] * W, "all-zero job sums to infinity")

    # B6 as the verifier gives it: static CRS row (n2 = 256), dynamic row
    # (n2 = 2048) of the extended table [9, 1, 2048]
    table = curve.StackedVec.from_affine([_curve_points(1024, rng)],
                                         device=dev, pad_to=1024).table()
    sums = {}
    for n2 in (256, 2048):
        tab = curve.pmap(lambda t: t[:, :, :n2].contiguous(), table)
        dig = _rand_digits((1, n2, W), rng)
        dig[0, :17, 0] = torch.arange(-8, 9, dtype=torch.int32)
        sums[n2], _ = check_msm(tab, dig.to(dev), keep=True)

    # B5: final MSM Horner [33, 1], a ragged [33, 7], the decode's subgroup
    # Horner [33, 2048]
    dig = _rand_digits((2048, W), rng).to(dev)
    sel_big = curve.pmap(lambda t: t.contiguous(), curve.table_select_windows(
        curve.pmap(lambda t: t[:, 0], table), dig))            # [33, 2048]
    sel_one = curve.pmap(lambda t: t.transpose(0, 1).contiguous(),
                         sums[2048])                            # [33, 1]
    check_combine(sel_one, keep=False)
    check_combine(curve.pmap(lambda t: t[:, :7].contiguous(), sel_big),
                  keep=False)
    check_combine(sel_big, keep=True)

    # B5 at the corners of the complete formulas, one row each: infinity in
    # every window; an accumulator P that meets sel = 16 P after its four
    # doublings (the add is a doubling); the same with -16 P (the sum is
    # infinity, and the row goes on); points only in the last window
    p, q = pts[7], pts[8]
    p16 = fh.g1_mul(p, 16)
    cols = [[None] * W for _ in range(4)]
    cols[1][3], cols[1][4] = p, p16
    cols[2][3], cols[2][4], cols[2][9] = p, fh.g1_neg(p16), q
    cols[3][W - 1] = q
    sel_c = curve.pmap(
        lambda t: t.reshape(W, len(cols), fp.NWORDS).contiguous(),
        curve.from_affine_host([c[w] for w in range(W) for c in cols],
                               device=dev))
    got = curve.to_affine_host(check_combine(sel_c, keep=False,
                                             what=" corner rows"))
    check(got == [None, fh.g1_mul(p, 32 * 16 ** (W - 5)),
                  fh.g1_mul(q, 16 ** (W - 10)), q],
          "windowed_combine corner rows against the host's group law")
    return res


def _first_attempt_rejected(label: bytes):
    """A host transcript whose next challenge under `label` is rejected at
    least once: (state bytes, pos, pos_begin, attempts)."""
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    from go_curdleproofs_tpu_torch.utils.transcript import Transcript

    for pre in range(64):
        def fresh():
            t = Transcript(b"chip_smoke")
            t.append_message(b"prefix", bytes(pre))
            return t
        probe, attempts = fresh(), 1
        while int.from_bytes(probe.inner.challenge_bytes(label, 32),
                             "big") >= fh.R:
            attempts += 1
        if attempts > 1:
            s = fresh().inner.strobe
            return bytes(s.state), s.pos, s.pos_begin, attempts
    raise RuntimeError("no rejected first attempt in 64 prefixes")


def phase_kernels_device_prover(dev: torch.device) -> dict:
    """The device prover's kernels vs their plain versions on the card, at
    that path's shapes, and the two forms of a per-point scalar
    multiplication side by side."""
    from go_curdleproofs_tpu_torch.models import device_common
    from go_curdleproofs_tpu_torch.ops import curve, fr, kernels, strobe_dev
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    from go_curdleproofs_tpu_torch.utils.transcript import Transcript

    rng = random.Random(2025)
    res = {}

    def report(name, shape, ms, plain_ms, bnd, keep, what=""):
        prev = None if what else PREVIOUS_DESIGN_MS.get(f"{name} {shape}")
        print(f"{name} {shape}{what}: exact; kernel {ms:.4f} ms"
              + (f" (previous design {prev:.4f} ms)" if prev else "")
              + f", plain {plain_ms:.2f} ms, bound {bnd['bound_ms']:.6f} ms "
              f"by {bnd['bound_by']}")
        if keep:
            res[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, **bnd)

    # B8: gamma^-1 = gamma^(r-2) over 1 and 8 elements (with 0, 1, r-1).
    # The bound counts the work of the 4-bit window ladder, as B7's does:
    # squarings at 36 + 64 multiply-adds, products at 128.
    e = fh.R - 2
    n_sqr, n_mul = ladder_steps(e)
    for n in (8, 1):
        vals = ([0, 1, fh.R - 1] + [rng.randrange(fh.R)
                                    for _ in range(5)])[-n:]
        x = fr.from_ints(vals, dev)
        got, want = kernels.fr_pow_fixed(x, e), kernels.fr_pow_fixed_plain(x,
                                                                           e)
        check(torch.equal(got, want) and fr.to_ints(got)
              == [pow(v, e, fh.R) for v in vals], f"fr_pow_fixed [{n}]")
        report("fr_pow_fixed", f"[{n}] exponent r-2",
               kernel_ms(lambda: kernels.fr_pow_fixed(x, e)),
               cuda_ms(lambda: kernels.fr_pow_fixed_plain(x, e), 1),
               bound(2 * n * FR_BYTES, n * (
                   n_mul + n_sqr * FR_MADS_PER_SQUARE / FR_MADS_PER_PRODUCT),
                   FR_MADS_PER_PRODUCT),
               keep=n == 1)
    # awkward exponents: below 16, all ones, zero nibbles, every bit length
    # mod 4, on 32 elements with 0, 1 and r - 1
    vals = [0, 1, fh.R - 1] + [rng.randrange(fh.R) for _ in range(29)]
    x = fr.from_ints(vals, dev)
    for e in (1, 2, 15, 16, 17, (1 << 255) - 1, (1 << 256) - 1,
              0x9000A00000B0000C0D, 0x1F3, 0x2F03, 0x7000F, 1 << 252):
        got = kernels.fr_pow_fixed(x, e)
        check(torch.equal(got, kernels.fr_pow_fixed_plain(x, e))
              and fr.to_ints(got) == [pow(v, e, fh.R) for v in vals],
              f"fr_pow_fixed exponent {e:#x}")
    print("fr_pow_fixed at 12 small and awkward exponents: exact")
    # one Fr product and one square of a lone warp, from the chain: 2^128
    # is 128 squarings, 2^252 124 more, 2^256 - 1 adds 63 products. Each of
    # these launches outlasts the host's call, so the events read the card
    # (exponent 1, the table alone, would read the wrapper's call instead).
    one = x[3:4].contiguous()
    t_128, t_sq, t_all = (kernel_ms(lambda: kernels.fr_pow_fixed(one, e), 10)
                          for e in (1 << 128, 1 << 252, (1 << 256) - 1))
    print(f"lone warp, Fr, from fr_pow_fixed [1] at exponents 2^128 / 2^252 "
          f"/ 2^256-1 ({t_128:.4f} / {t_sq:.4f} / {t_all:.4f} ms): one "
          f"product {(t_all - t_sq) / 63 * 1e3:.3f} us, one square "
          f"{(t_sq - t_128) / 124 * 1e3:.3f} us")

    # the Fr product's carry chains: every pair of the edge elements and
    # every raw first operand against every edge element, word for word
    # against the plain version and Python ints, then random pairs (half
    # of them with raw first operands) up to 65,536; the square
    # (fr_pow_fixed at 2) against the product
    edge, raw = fr_edge_elements(rng)
    xs = [u for u in edge + raw for _ in edge]
    ys = [v for _ in edge + raw for v in edge]
    n_grid = len(xs)
    xs += [rng.randrange(1 << 256 if i % 2 else fh.R)
           for i in range(65536 - n_grid)]
    ys += [rng.randrange(fh.R) for _ in range(65536 - n_grid)]
    a, b = _raw_fr(xs, dev), _raw_fr(ys, dev)
    got = kernels.fr_mont_mul(a, b)
    r_inv = pow(1 << 256, -1, fh.R)
    check(torch.equal(got, kernels.fr_mont_mul_plain(a, b)),
          "fr product stress: 65,536 pairs against the plain version")
    check(_fr_values(got) == [u * v * r_inv % fh.R for u, v in zip(xs, ys)],
          "fr product stress: 65,536 pairs against Python ints")
    check(torch.equal(kernels.fr_pow_fixed(b, 2), kernels.fr_mont_mul(b, b)),
          "fr_pow_fixed(x, 2) == fr_mont_mul(x, x): the square against the "
          "product")
    print(f"fr product stress: {len(edge)} edge elements and {len(raw)} raw "
          f"first operands against every edge element ({n_grid} pairs), "
          f"{65536 - n_grid} random pairs: exact against the plain version "
          f"and Python ints; fr_pow_fixed(x, 2) == fr_mont_mul(x, x) on all "
          f"65,536")

    # the Fr multiply: [128] lanes, and [128] lanes by one element
    vals = [0, 1, fh.R - 1] + [rng.randrange(fh.R) for _ in range(125)]
    a, b = fr.from_ints(vals, dev), fr.from_ints(vals[::-1], dev)
    got = kernels.fr_mont_mul(a, b)
    check(torch.equal(got, kernels.fr_mont_mul_plain(a, b))
          and fr.to_ints(got) == [x * y % fh.R for x, y in
                                  zip(vals, vals[::-1])], "fr_mont_mul [128]")
    report("fr_mont_mul", [128],
           kernel_ms(lambda: kernels.fr_mont_mul(a, b)),
           cuda_ms(lambda: kernels.fr_mont_mul_plain(a, b)),
           bound(3 * 128 * FR_BYTES, 128, FR_MADS_PER_PRODUCT), keep=True)
    one = b[7].contiguous()
    check(torch.equal(kernels.fr_mont_mul(a, one),
                      kernels.fr_mont_mul_plain(a, one)),
          "fr_mont_mul [128] x one element")
    report("fr_mont_mul", "[128] x one element",
           kernel_ms(lambda: kernels.fr_mont_mul(a, one)),
           cuda_ms(lambda: kernels.fr_mont_mul_plain(a, one)),
           bound((2 * 128 + 1) * FR_BYTES, 128, FR_MADS_PER_PRODUCT),
           keep=False)

    # B4 at the window loop's batches: 2n lanes of 1, 2 and 12 points, both
    # load stages. Operand given: the corners of the complete formulas.
    pts, qts = _curve_points(24, rng), _curve_points(24, rng)
    pts[0] = None                               # 16 * infinity + Q
    qts[1] = None                               # 16 * P + infinity
    pts[2] = qts[2] = None
    qts[3] = fh.g1_mul(pts[3], 16)              # the add is a doubling
    qts[4] = fh.g1_neg(fh.g1_mul(pts[4], 16))   # the add cancels
    step_ops = 4 * PRODUCTS_DOUBLE + PRODUCTS_ADD
    for n in (2, 4, 24):
        pv = curve.from_affine_host(pts[-n:] if n < 24 else pts, device=dev)
        qv = curve.from_affine_host(qts[-n:] if n < 24 else qts, device=dev)
        got = kernels.point_x16_add(pv, qv)
        want = kernels.point_x16_add_plain(pv, qv)
        check(_point_err(got, want) == 0, f"point_x16_add [{n}]")
        if n == 24:
            check(curve.to_affine_host(got)
                  == [fh.g1_add(fh.g1_mul(p, 16) if p else None, q)
                      for p, q in zip(pts, qts)], "point_x16_add edge cases")
        report("point_x16_add", [n],
               kernel_ms(lambda: kernels.point_x16_add(pv, qv)),
               cuda_ms(lambda: kernels.point_x16_add_plain(pv, qv)),
               bound(9 * n * ELEM_BYTES, n * step_ops), keep=False,
               what=", operand given")
    # Operand selected from the table, as the window loop runs it: the
    # table of n / 2 points of which the first is infinity; windows 0..16
    # give lane 0 (an infinity row) and lane 2 (a finite row) every digit
    # from -8 to 8; the accumulator keeps the corner rows above.
    W = curve.NUM_WINDOWS
    for n in (2, 4, 24):
        base = [None] + _curve_points(n // 2 - 1, rng)
        table = curve.extend_table_glv(curve.build_table(
            curve.from_affine_host(base, device=dev)))         # [9, n]
        dig = _rand_digits((n, W), rng)
        dig[0, :17] = torch.arange(-8, 9, dtype=torch.int32)
        if n > 2:
            dig[2, :17] = torch.arange(-8, 9, dtype=torch.int32)
        dig = dig.to(dev)
        acc_pts = (pts[-n:] if n < 24 else pts)
        acc = curve.from_affine_host(acc_pts, device=dev)
        lanes = curve.to_affine_host(curve.pmap(lambda t: t[1], table))
        for w in range(17 if n == 24 else 3):
            got = kernels.point_x16_add_select(acc, table, dig, w)
            want = kernels.point_x16_add_select_plain(acc, table, dig, w)
            check(_point_err(got, want) == 0,
                  f"point_x16_add [{n}] operand selected, window {w}")
            if n == 24:
                col = dig[:, w].tolist()
                check(curve.to_affine_host(got) == [
                    fh.g1_add(fh.g1_mul(a, 16) if a else None,
                              fh.g1_mul(q, d % fh.R) if q else None)
                    for a, q, d in zip(acc_pts, lanes, col)],
                    f"point_x16_add select, window {w}, against the host's "
                    f"group law")
        same = curve.pmap(torch.clone, acc)
        kernels.point_x16_add_select(same, table, dig, 1, out=same)
        check(_point_err(same, kernels.point_x16_add_select_plain(
            acc, table, dig, 1)) == 0,
            f"point_x16_add [{n}] operand selected, in place")
        scratch = curve.pmap(torch.clone, acc)
        report("point_x16_add", [n],
               kernel_ms(lambda: kernels.point_x16_add_select(
                   scratch, table, dig, 1, out=scratch)),
               cuda_ms(lambda: kernels.point_x16_add_select_plain(
                   acc, table, dig, 1)),
               bound((6 + 27) * n * ELEM_BYTES + 4 * dig.numel(),
                     n * step_ops), keep=n == 24)

    # the per-point scalar multiplication, both forms, at 1, 2 and 12 points
    for n in (1, 2, 12):
        sc = [rng.randrange(fh.R) for _ in range(n)]
        pv = curve.from_affine_host(pts[5:5 + n], device=dev)
        dig = curve._digits(curve.scalars_to_digits(sc), dev)
        steps = curve.scalar_mul_steps(pv, dig)
        combine = curve.scalar_mul_device(pv, dig)
        check(curve.to_affine_host(steps) == curve.to_affine_host(combine)
              == [fh.g1_mul(p, s) for p, s in zip(pts[5:5 + n], sc)],
              f"scalar_mul_steps == scalar_mul_device [{n}]")
        print(f"scalar multiplication of {n} point(s): window loop on "
              f"point_x16_add "
              f"{cuda_ms(lambda: curve.scalar_mul_steps(pv, dig)):.3f} ms, "
              f"one windowed_combine launch "
              f"{cuda_ms(lambda: curve.scalar_mul_device(pv, dig)):.3f} ms")

    # the transcript: the same-multiscalar step's 256 tracker-point rows
    # under one label from a mid-rate position
    host = Transcript(b"chip_smoke")
    host.append_message(b"prefix", bytes(range(41)))
    rows = bytes(rng.randrange(256) for _ in range(256 * 48))
    ts = device_common.transcript_to_device(host, dev)
    pos, pb = ts.pos, ts.pos_begin
    template, tr_pos, pbs, pos1, pb1 = strobe_dev._rows_layout(
        pos, pb, b"same_msm_step1", 256, 48, dev)
    stream = template.index_copy(
        0, tr_pos, strobe_dev.bytes_tensor(rows, dev))
    got = kernels.strobe_absorb_stream(ts.st, stream, pos, pbs)
    want = kernels.strobe_absorb_stream_plain(ts.st, stream, pos, pbs)
    for i in range(256):
        host.append_message(b"same_msm_step1", rows[48 * i:48 * i + 48])
    hs = host.inner.strobe
    check(torch.equal(got, want) and bytes(got.tolist()) == bytes(hs.state)
          and (pos1, pb1) == (hs.pos, hs.pos_begin),
          "strobe_absorb_stream [256 x 48]")
    n_stream = stream.numel()
    print(f"strobe_absorb_stream [256 x 48]: {n_stream} bytes, "
          f"{pbs.numel()} permutations")
    report("strobe_absorb_stream", "[256 x 48]",
           kernel_ms(lambda: kernels.strobe_absorb_stream(ts.st, stream, pos,
                                                          pbs)),
           cuda_ms(lambda: kernels.strobe_absorb_stream_plain(
               ts.st, stream, pos, pbs), 1),
           bound(400 + n_stream + pbs.numel(), pbs.numel(),
                 KECCAK_INT32_OPS), keep=True)

    # every start position and length that meets an edge of a lane's word
    # or of the rate (lane 20's word straddles byte 166), with and without
    # the forced permutation: against the plain version with random
    # pos_begin bytes, and against the host STROBE with the pos_begin it
    # would use
    state = bytes(rng.randrange(256) for _ in range(200))
    st = strobe_dev.bytes_tensor(state, dev)
    for start in (0, 1, 7, 8, 159, 160, 165):
        for n in (0, 1, 5, 6, 166, 167, 1000):
            data = bytes(rng.randrange(256) for _ in range(n))
            data_t = torch.tensor(list(data), dtype=torch.uint8, device=dev)
            n_cross = (start + n) // kernels.STROBE_R
            pbs_r = torch.tensor([rng.randrange(167) for _ in range(n_cross)],
                                 dtype=torch.uint8, device=dev)
            for final_pb in (None, 9):
                check(torch.equal(
                    kernels.strobe_absorb_stream(st, data_t, start, pbs_r,
                                                 final_pb),
                    kernels.strobe_absorb_stream_plain(st, data_t, start,
                                                       pbs_r, final_pb)),
                    f"strobe_absorb_stream from {start}, {n} bytes, "
                    f"final_pb {final_pb}, against the plain version")
            hs = Transcript(b"chip_smoke").inner.strobe
            hs.state[:], hs.pos, hs.pos_begin = state, start, 3
            pbs_h = torch.tensor([3] + [0] * (n_cross - 1) if n_cross else [],
                                 dtype=torch.uint8, device=dev)
            hs._absorb(data)
            got = kernels.strobe_absorb_stream(st, data_t, start, pbs_h)
            check(bytes(got.tolist()) == bytes(hs.state),
                  f"strobe_absorb_stream from {start}, {n} bytes, against "
                  f"the host STROBE")
            if hs.pos != 0:
                final_pb = hs.pos_begin
                hs._run_f()
                got = kernels.strobe_absorb_stream(st, data_t, start, pbs_h,
                                                   final_pb)
                check(bytes(got.tolist()) == bytes(hs.state),
                      f"strobe_absorb_stream from {start}, {n} bytes, "
                      f"forced permutation, against the host STROBE")
    print("strobe_absorb_stream from positions 0, 1, 7, 8, 159, 160, 165 "
          "with 0, 1, 5, 6, 166, 167 and 1000 bytes, with and without the "
          "forced permutation: exact against the plain version and the host "
          "STROBE")

    # a challenge whose first attempt is rejected; every attempt runs one
    # permutation, the final re-absorb stays inside the rate
    label = b"same_msm_gamma"
    state, pos, pb, attempts = _first_attempt_rejected(label)
    st = strobe_dev.bytes_tensor(state, dev)
    g_st, g_ch = kernels.strobe_challenge32(st, label, pos, pb)
    w_st, w_ch = kernels.strobe_challenge32_plain(st, label, pos, pb)
    host = Transcript(b"chip_smoke")
    host.inner.strobe.state[:] = state
    host.inner.strobe.pos, host.inner.strobe.pos_begin = pos, pb
    c = host.get_and_append_challenge(label)
    check(torch.equal(g_st, w_st) and torch.equal(g_ch, w_ch)
          and int.from_bytes(bytes(g_ch.tolist()), "big") == c
          and bytes(g_st.tolist()) == bytes(host.inner.strobe.state),
          "strobe_challenge32 with a rejected attempt")
    report("strobe_challenge32", f"{attempts} attempts",
           kernel_ms(lambda: kernels.strobe_challenge32(st, label, pos, pb)),
           cuda_ms(lambda: kernels.strobe_challenge32_plain(st, label, pos,
                                                            pb), 1),
           bound(400 + 32, attempts, KECCAK_INT32_OPS), keep=True)
    return res


def _trackers(pairs):
    from go_curdleproofs_tpu_torch.models import whisk

    return [whisk.WhiskTracker(bytes.fromhex(a), bytes.fromhex(b))
            for a, b in pairs]


def _golden_whisk_pre(w):
    """The golden Whisk vector's pre-trackers, from its tracker seed."""
    from go_curdleproofs_tpu_torch.models import whisk
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    r = Rand(w["tracker_seed"])
    pre = []
    for _ in range(w["ell"]):
        rr, kk = r.get_fr(), r.get_fr()
        pre.append(whisk.WhiskTracker.from_points(
            fh.g1_mul(fh.G1_GEN, rr), fh.g1_mul(fh.G1_GEN, rr * kk % fh.R)))
    return pre


def phase_verifier(dev: torch.device, card: str):
    """The ELL=124 verifier path. Returns (launch counts over the two
    fixture verifies, the CRS, the fixture)."""
    from go_curdleproofs_tpu_torch.models import curdleproof, whisk
    from go_curdleproofs_tpu_torch.ops import kernels
    from go_curdleproofs_tpu_torch.utils import codec
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    with open(FIXTURE) as f:
        fx = json.load(f)
    t0 = time.perf_counter()
    crs = curdleproof.generate_crs(fx["ell"], Rand(fx["crs_seed"]),
                                   device=dev)
    torch.cuda.synchronize()
    print(f"CRS ell={fx['ell']}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    insts = [(_trackers(i["pre"]), _trackers(i["post"]),
              bytes.fromhex(i["proof"])) for i in fx["instances"]]

    def verify(pre, post, proof):
        return whisk.is_valid_whisk_shuffle_proof(crs, pre, post, proof,
                                                  Rand(7), device=dev)

    kernels.reset_launches()
    t0 = time.perf_counter()
    ok0 = verify(*insts[0])
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    ok1 = verify(*insts[1])
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    print(f"fixture verify: {ok0}, {ok1}; launches over both {counts}")
    check(ok0 and ok1, "ELL=124 fixture proofs accepted")
    for name in EARLIER_KERNELS:
        check(counts[name] > 0, f"{name} launched on the verifier path")

    pre, post, proof = insts[0]
    bad = bytearray(proof)
    bad[SMS_FLIP_BYTE] ^= 0x01
    check(not verify(pre, post, bytes(bad)), "flipped scalar x rejected")
    swapped = list(post)
    swapped[0], swapped[1] = swapped[1], swapped[0]
    check(not verify(pre, swapped, proof), "swapped post trackers rejected")
    print("tampered proofs rejected")

    warm_ms = cuda_ms(lambda: check(verify(*insts[0]), "warm verify"))
    kernels.reset_launches()
    check(verify(*insts[0]), "counted verify")
    check_msm_launches(kernels.launches, "verify")
    print(f"verify ELL=124: cold {cold_ms:.1f} ms, warm {warm_ms:.1f} ms "
          f"(median of 3) on {card}; launches per verify "
          f"{dict(kernels.launches)}")

    with open(GOLDEN) as f:
        gv = json.load(f)
    w = gv["whisk"]
    gcrs = curdleproof.generate_crs(w["ell"], Rand(w["crs_seed"]), device=dev)
    blob = b"".join(codec.g1_to_bytes(p) for p in
                    gcrs.gs + gcrs.hs + [gcrs.h, gcrs.gt, gcrs.gu,
                                         gcrs.gsum, gcrs.hsum])
    crs_vec = next(v for v in gv["shuffle"] if v["crs_seed"] == w["crs_seed"])
    check(hashlib.sha256(blob).hexdigest() == crs_vec["crs_sha256"],
          "golden ell=12 CRS bytes")
    ph = bytes.fromhex(w["post_trackers_hex"])
    gpost = [whisk.WhiskTracker(ph[96 * i:96 * i + 48],
                                ph[96 * i + 48:96 * i + 96])
             for i in range(w["ell"])]
    check(whisk.is_valid_whisk_shuffle_proof(
        gcrs, _golden_whisk_pre(w), gpost, bytes.fromhex(w["proof_hex"]),
        Rand(3), device=dev), "golden ell=12 Whisk proof accepted")
    t = gv["tracker"]
    k = int(t["k"], 16)
    r_g = fh.g1_mul(fh.G1_GEN, t["r"])
    check(whisk.is_valid_whisk_tracker_proof(
        whisk.WhiskTracker.from_points(r_g, fh.g1_mul(r_g, k)),
        codec.g1_to_bytes(fh.g1_mul(fh.G1_GEN, k)),
        bytes.fromhex(t["proof_hex"])), "golden tracker proof accepted")
    print("golden ell=12 Whisk proof and tracker proof accepted")
    return counts, crs, insts, gv


def phase_prover(dev: torch.device, card: str, crs, insts, gv) -> dict:
    """The prover path on the card: golden bytes reproduced, then one proof
    at ELL=124. Returns the launch counts of one ELL=124 prove."""
    from go_curdleproofs_tpu_torch.models import curdleproof, whisk
    from go_curdleproofs_tpu_torch.ops import kernels
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    w = gv["whisk"]
    gcrs = curdleproof.generate_crs(w["ell"], Rand(w["crs_seed"]), device=dev)
    post, proof = whisk.generate_whisk_shuffle_proof(
        gcrs, _golden_whisk_pre(w), Rand(w["prove_seed"]), device=dev)
    check(proof.hex() == w["proof_hex"], "golden ell=12 Whisk proof bytes")
    check("".join((t.r_g + t.k_r_g).hex() for t in post)
          == w["post_trackers_hex"], "golden ell=12 post-trackers")

    for vec in gv["shuffle"]:
        check(_golden_shuffle_proof(vec, "host", dev)
              == (vec["m_hex"], vec["proof_hex"]),
              f"golden ell={vec['ell']} commitment M and shuffle proof bytes")

    t = gv["tracker"]
    k = int(t["k"], 16)
    r_g = fh.g1_mul(fh.G1_GEN, t["r"])
    tp = whisk.generate_whisk_tracker_proof(
        whisk.WhiskTracker.from_points(r_g, fh.g1_mul(r_g, k)), k,
        Rand(t["rand_seed"]))
    check(tp.hex() == t["proof_hex"], "golden tracker proof bytes")
    print("golden ell=12 Whisk proof, ell=12 and ell=60 shuffle proofs and "
          "tracker proof reproduced byte for byte")

    pre = insts[0][0]

    def prove():
        return whisk.generate_whisk_shuffle_proof(crs, pre, Rand(PROVE_SEED),
                                                  device=dev)

    kernels.reset_launches()
    t0 = time.perf_counter()
    post, proof = prove()
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(kernels.launches)
    check(len(proof) == whisk.WHISK_SHUFFLE_PROOF_SIZE, "proof size 4576")
    check_msm_launches(counts, "prove")
    for name in EARLIER_KERNELS:
        check(counts[name] > 0, f"{name} launched on the prover path")

    def verify(proof_bytes):
        return whisk.is_valid_whisk_shuffle_proof(
            crs, pre, post, proof_bytes, Rand(11), device=dev)

    check(verify(proof), "ELL=124 proof of the port accepted by its verifier")
    bad = bytearray(proof)
    bad[SMS_FLIP_BYTE] ^= 0x01
    check(not verify(bytes(bad)), "flipped byte of the new proof rejected")
    warm_ms = cuda_ms(lambda: check(prove()[1] == proof, "prove repeats"))
    print(f"prove ELL=124: cold {cold_ms:.1f} ms, warm {warm_ms:.1f} ms "
          f"(median of 3) on {card}; proof verified, flipped byte rejected; "
          f"launches per prove {counts}")
    return counts, post, proof, (cold_ms, warm_ms)


def _golden_shuffle_proof(vec, prover: str, dev: torch.device):
    """A golden shuffle vector's commitment M and proof regenerated from its
    seeds (hex, hex)."""
    from go_curdleproofs_tpu_torch.models import curdleproof
    from go_curdleproofs_tpu_torch.utils import codec
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    ell = vec["ell"]
    scrs = curdleproof.generate_crs(ell, Rand(vec["crs_seed"]), device=dev)
    r = Rand(vec["inst_seed"])
    Rs, Ss = r.get_g1s(ell), r.get_g1s(ell)
    rp = Rand(vec["prove_seed"])
    perm = rp.generate_permutation(ell)
    k = rp.get_fr()
    Ts, Us, M, rs_m = curdleproof.shuffle_permute_commit(
        scrs.gs, scrs.hs, Rs, Ss, perm, k, rp, device=dev)
    sp = curdleproof.prove(scrs, Rs, Ss, Ts, Us, M, perm, k, rs_m, rp,
                           device=dev, prover=prover)
    buf = io.BytesIO()
    sp.serialize(buf)
    return codec.g1_to_bytes(M).hex(), buf.getvalue().hex()


def phase_device_prover(dev: torch.device, card: str, crs, insts, gv,
                        host_post, host_proof: bytes, host_ms) -> dict:
    """The device-resident one-fetch prover on the card. Returns the
    launch counts of one ELL=124 device prove."""
    from go_curdleproofs_tpu_torch.models import (curdleproof,
                                                  device_common,
                                                  device_prover_full, whisk)
    from go_curdleproofs_tpu_torch.ops import kernels
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    # From here on the chain between the upload and the one fetch runs
    # with synchronising calls turned into errors, and every fetch counts.
    chain, fetch = device_prover_full._chain, device_common.fetch
    seen = dict(chains=0, fetches=0)

    def guarded_chain(inp):
        seen["chains"] += 1
        torch.cuda.set_sync_debug_mode("error")
        try:
            return chain(inp)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def counted_fetch(tensors):
        seen["fetches"] += 1
        return fetch(tensors)

    device_prover_full._chain = guarded_chain
    device_prover_full.fetch = counted_fetch
    try:
        for vec in gv["shuffle"]:
            check(_golden_shuffle_proof(vec, "device", dev)
                  == (vec["m_hex"], vec["proof_hex"]),
                  f"golden ell={vec['ell']} shuffle proof bytes, "
                  f"prover=device")
        w = gv["whisk"]
        gcrs = curdleproof.generate_crs(w["ell"], Rand(w["crs_seed"]),
                                        device=dev)
        _, gproof = whisk.generate_whisk_shuffle_proof(
            gcrs, _golden_whisk_pre(w), Rand(w["prove_seed"]), device=dev,
            prover="device")
        check(gproof.hex() == w["proof_hex"],
              "golden ell=12 Whisk proof bytes, prover=device")
        print("golden ell=12 and ell=60 shuffle proofs and ell=12 Whisk "
              "proof reproduced byte for byte with prover=device")

        pre = insts[0][0]

        def prove(prover="device"):
            return whisk.generate_whisk_shuffle_proof(
                crs, pre, Rand(PROVE_SEED), device=dev, prover=prover)

        seen.update(chains=0, fetches=0)
        kernels.reset_launches()
        t0 = time.perf_counter()
        post, proof = prove()
        torch.cuda.synchronize()
        cold_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(kernels.launches)
        check(seen == dict(chains=1, fetches=1),
              f"one chain and one fetch per device prove, saw {seen}")
        check(proof == host_proof and
              [(t.r_g, t.k_r_g) for t in post]
              == [(t.r_g, t.k_r_g) for t in host_post],
              "ELL=124 prover=device proof byte-identical to prover=host")
        for name, n in counts.items():
            check(n > 0, f"{name} launched by the device prove")
        check_msm_launches(counts, "device prove")
        for name, n in DEVICE_PROVE_LAUNCHES.items():
            check(counts[name] == n, f"{n} {name} launches a device prove, "
                  f"saw {counts[name]}")
        check(whisk.is_valid_whisk_shuffle_proof(
            crs, pre, post, proof, Rand(11), device=dev),
            "ELL=124 device proof accepted by the verifier")
        bad = bytearray(proof)
        bad[SMS_FLIP_BYTE] ^= 0x01
        check(not whisk.is_valid_whisk_shuffle_proof(
            crs, pre, post, bytes(bad), Rand(11), device=dev),
            "flipped byte of the device proof rejected")
        # parent, change, change, parent
        host_warm = [cuda_ms(lambda: prove("host"), 2)]
        dev_warm = cuda_ms(lambda: check(prove()[1] == proof,
                                         "device prove repeats"), 5)
        host_warm.append(cuda_ms(lambda: prove("host"), 2))
    finally:
        device_prover_full._chain = chain
        device_prover_full.fetch = fetch
    print("no synchronising call between upload and the one fetch "
          "(chain run under set_sync_debug_mode('error'))")
    print(f"device prove ELL=124: cold {cold_ms:.1f} ms, warm {dev_warm:.1f} "
          f"ms (median of 5); host prove: cold {host_ms[0]:.1f} ms, warm "
          f"{host_ms[1]:.1f} ms earlier, {host_warm[0]:.1f} and "
          f"{host_warm[1]:.1f} ms around the device runs; on {card}; "
          f"byte-identical proofs, verified, flipped byte rejected; "
          f"launches per device prove {counts}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from go_curdleproofs_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    card = phase_env(dev)
    phase_build()
    timings = phase_kernels(dev)
    timings.update(phase_kernels_device_prover(dev))
    verify_counts, crs, insts, gv = phase_verifier(dev, card)
    prove_counts, post, proof, host_ms = phase_prover(dev, card, crs, insts,
                                                      gv)
    device_counts = phase_device_prover(dev, card, crs, insts, gv, post,
                                        proof, host_ms)
    check("jax" not in sys.modules
          and "go_curdleproofs_tpu" not in sys.modules,
          "neither jax nor the JAX package imported")
    torch.cuda.synchronize()
    print(card)
    summary = [dict(name=name, route="cuda",
                    source=CSRC + kernels.KERNEL_SOURCE[name],
                    replaces=REPLACES[name],
                    launches=verify_counts[name] + prove_counts[name]
                    + device_counts[name],
                    launches_two_verifies=verify_counts[name],
                    launches_one_prove=prove_counts[name],
                    launches_one_device_prove=device_counts[name],
                    library_ms=None, **timings[name]) for name in REPLACES]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
