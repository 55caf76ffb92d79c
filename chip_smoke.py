#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port (go_curdleproofs_tpu_torch) on the card:

  1. environment: versions, the card, its power limit, whether the host C
     library or the Python path serves the transcript;
  2. build: compiles the CUDA kernels from ops/csrc/ with nvcc (one process
     per source, started together) and the host C library with cc; ptxas
     must report no stack frame and no spills for point_add_kernel,
     point_double_kernel, every instance of mont_mul_kernel,
     fr_mont_mul_kernel, strobe_challenge32_kernel and
     decode_points_kernel;
  3. decode_points at 1, 17, 248, 585, 2,141 and 18,720 points (subgroup
     points of both signs, x off the curve, points on the curve outside the
     subgroup, the order-3 point) against its plain version word for word
     and flag for flag, and its flags and y against the host; timed at 585
     and 2,141 points by CUDA events and the profiler beside the bound of
     benchmark/core/roofline.py; one batch_decompress on the card is one
     decode_points launch, no other kernel and one device-to-host copy, and
     raises the host codec's errors, on-curve first;
     then each of the other eleven kernels against its plain torch version
     on the card, at the shapes the verifier and the provers give it,
     compared exactly by value (integers, tolerance 0), with timings and
     roofline bounds;
     point_add at 1, 2, 4, 7, 24, 33, 1025 and [4, 1, 1024] points and
     point_double at 1, 4, 24, 1024 and 1025, with infinity in either or
     both operands, P + P, P + (-P) and P + P through one tensor, also
     against the host's group law;
     windowed_combine and msm_select_reduce also at ragged shapes, at a
     forced split, and at inputs that hit the corners of the complete
     point formulas;
     mont_mul at every batch size the paths give it (one element broadcast
     on either side, one tensor as both operands) and above the grid-stride
     limit of its lane teams; the Fp product on 65,536 pairs (every pair of
     ~45 edge elements, then random ones) and the dedicated square against
     the product; pow_fixed
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
     exactly 28, strobe_challenge32 exactly 22 and fr_mont_mul exactly 157
     launches a device prove, and fr_mont_mul at every batch size of that
     prove (recorded as it runs) exact against its plain version, as
     pairs and broadcast on either side, with its time a launch on the
     card. point_add and point_double are launched exactly 3 and 1 times a
     verify, 11 and 5 a prove, 61 and 14 a device prove, mont_mul 1, 10
     and 138, decode_points once each; the counted device prove runs
     with the spans on
     (profiling.enable()) and prints its span table (the spans inside the chain run under the
     sync-debug mode too); it runs the chain eagerly, the next device prove
     captures the chain into a CUDA graph and the two after replay it,
     all with the spans on: each byte-identical to the eager prove, its
     `chain` span counting `chain.replays` 1 and the eager prove's
     `chain.kernels`, the replays' spans those outside the chain alone;
     the last replay runs under torch.profiler, and each hand-written
     kernel's launches counted by name in the card's events, less its
     wrapper launches outside the chain, equal the eager chain's; the
     replay's counts on the card are the device prove's in the summary,
     and the warm device prove times are replays;
  8. (run before phase 7) physical folding, the device MSM entry points,
     the functional STROBE, ELL=252 and ELL=508: one Whisk shuffle at each
     (bench.py's two largest sizes; the trackers from one batch_scalar_mul
     on the card) proved with prover="host", verified, a flipped byte
     rejected, prover="device" byte for byte the same, cold and warm times
     and launch counts; msm_device at __graft_entry__.entry()'s inputs
     (rebuilt: 128 multiples of G, 62-bit scalars), at N=512 and over two
     leading batch dims, msm_windows_device, msm_stacked_device and
     msm_rows_device at k=3, n=512, m=4 and k=2, n=128, each against
     fh.g1_msm; DeviceVec folded from the ELL=508 CRS's 512 bases and the
     ELL=124 CRS's 128 down to one point, each round's msm against
     FoldedBases.msm_many and the host's fold; StackedVec.fold at
     [2, 512] with a gamma per row; SState against the host STROBE,
     Merlin and transcript (40 operations across the rate, the Merlin
     vector, 9 chained challenges, three of them under labels of 33, 127
     and 300 bytes and each one strobe_challenge32 launch, inputs
     unchanged). Fold rounds, device MSMs and SState operations run
     under set_sync_debug_mode("error"); one fold round and one
     msm_device have their launches pinned; every launch shape of the
     phase is recorded and held against its plain version, with its
     time on the card and its bound; the phase prints its seconds;
  7. batched verification (parallel/) on a one-rank NCCL group made from a
     FileStore: the dry run (a 1,024-base sharded MSM against fh.g1_msm,
     both fixture proofs through verify_shuffle_proofs_batch), then
     batches of 2 (the fixture), 8 and 32 distinct ELL=124 proofs (a chain
     of shuffles from the host prover) accepted, each with one tampered
     proof rejected, launch counts pinned, warm batch ms and proofs/s on
     the group and with no group beside the same proofs verified one by
     one; the inputs of every launch shape of the b32 verify recorded as
     it runs (msm_select_reduce on 3 rows of 8,192 lanes, decode_points
     at the decode's size, windowed_combine, mont_mul, point_add,
     point_double) and each kernel held there against its plain version,
     with its time and bound; the b32 final MSM's 11,227 bases through
     sharded_msm again with three scalars moved, against the host.

The device prover's kernels (phase 3) are held at the shapes of that path
and at their corners: the Fr product on 65,536 pairs (every pair of ~40
edge elements and of raw first operands up to 2^256 - 1, then random
ones) against the plain version and Python ints, the square against the
product, the same grid in launches of 512 (the device prove's largest)
and every edge word broadcast on either side; fr_pow_fixed at [8] and [1]
with exponent r - 2 and at awkward
exponents, with the lone-warp time of one Fr product and one square;
strobe_absorb_stream at every start position and length that meets an
edge of the warp's lane words or of the rate, with and without the forced
permutation, against the plain version and the host STROBE;
strobe_challenge32 from every start position 0-165 with labels of 0, 9
and 32 bytes, at states that take 1, 2 and 3 attempts, against the plain
version and the host transcript; and with labels of 33, 95, 127, 166 and
300 bytes (the kernel's long instantiation) from every eighth start, 0,
165 and each label's edge starts, each challenge one launch, timed at 33,
127 and 300 bytes beside the chain of permutations it needs.

Prints the kernel summary as one JSON line, then as the last line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
non-zero and no result line is printed. Without CUDA it exits non-zero.
Imports neither jax nor the JAX package.
"""

import collections
import contextlib
import hashlib
import io
import json
import os
import platform
import random
import re
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
    "decode_points": "go_curdleproofs_tpu/ops/codec_batch.py:58",
}
# the kernels that the verifier and the host-orchestrated prover run (the
# host prover's inverses run pow_fixed too); the device-resident prover runs
# all of REPLACES
EARLIER_KERNELS = ("mont_mul", "point_add", "point_double",
                   "windowed_combine", "msm_select_reduce", "decode_points")
FIXTURE = os.path.join(ROOT, "tests", "fixture_whisk_ell124.json")
GOLDEN = os.path.join(ROOT, "tests", "golden_vectors.json")
SMS_FLIP_BYTE = 4520      # inside the same-multiscalar scalar x (4504-4535)
PROVE_SEED = 0x5EED       # Rand seed of the ELL=124 prove
# wrapper calls of one run at ELL=124 that a redesign of the kernels must
# leave as they are
PATH_LAUNCHES = {
    "verify": dict(windowed_combine=1, msm_select_reduce=2, point_add=3,
                   point_double=1, mont_mul=1, decode_points=1),
    "prove": dict(windowed_combine=22, msm_select_reduce=21, point_add=11,
                  point_double=5, mont_mul=10, decode_points=1),
    "device prove": dict(windowed_combine=22, msm_select_reduce=21,
                         point_add=61, point_double=14, mont_mul=138,
                         decode_points=1),
}
# kernels that ptxas must compile with no stack frame and no spills (every
# instance of a template)
NO_STACK_KERNELS = ("point_add_kernel", "point_double_kernel",
                    "mont_mul_kernel", "fr_mont_mul_kernel",
                    "strobe_challenge32_kernel", "decode_points_kernel")

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
# one permutation on one warp, in us (ops/csrc/transcript.cu; NVIDIA H100
# 80GB HBM3, 700 W): what bounds a challenge, one serial chain of them
PERMUTATION_US = 2.48
# challenge labels over 32 bytes, on both sides of each bound of the
# kernel's short design (the re-absorbed message crosses the rate from 94
# bytes, a retry's header from 126, a first header twice from 159)
LONG_LABEL_LENS = (33, 95, 127, 166, 300)

MADS_PER_SQUARE = 12 * 13 // 2 + 12 * 12   # 78 partial products, reduction
FR_MADS_PER_SQUARE = 8 * 9 // 2 + 8 * 8    # 36 partial products, reduction
# launches of one ELL=124 device prove that a redesign must leave as they are
BATCH_SIZES = (8, 32)     # chained batches, beside the fixture's two proofs
# wrapper calls of one batch verify of 2, 8 and 32 distinct ELL=124 proofs
# on a one-rank group (phase 7): one decode (one decode_points launch) and
# one final MSM whatever the batch; b32's ~19,000 bases take 5 rows of
# 4,096, added by a tree
_BATCH_FEW = dict(mont_mul=1, point_add=2, point_double=1, pow_fixed=0,
                  windowed_combine=1, msm_select_reduce=1, point_x16_add=0,
                  fr_pow_fixed=0, fr_mont_mul=0, strobe_absorb_stream=0,
                  strobe_challenge32=0, decode_points=1)
BATCH_LAUNCHES = {2: _BATCH_FEW, 8: _BATCH_FEW,
                  32: dict(_BATCH_FEW, point_add=4)}
# spans of a device prove with the spans on (profiling.enable(); `chain`
# and the eight spans after it inside the chain, which runs under
# sync-debug "error")
DEVICE_PROVE_SPANS = ("device_prove", "draws", "upload", "chain",
                      "sameperm_gpa", "blinders", "ipa", "ipa_round",
                      "step3_sigma", "samemsm", "samemsm_round", "finalize",
                      "fetch", "assemble")
# the spans of a replayed device prove: the chain's inner spans exist only
# where `_chain` runs (eagerly, or as it is captured)
DEVICE_REPLAY_SPANS = ("device_prove", "draws", "upload", "chain", "fetch",
                       "assemble")
DEVICE_PROVE_LAUNCHES = {"fr_pow_fixed": 17, "fr_mont_mul": 157,
                         "point_x16_add": 363,
                         "strobe_absorb_stream": 28,
                         "strobe_challenge32": 22}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def check_path_launches(counts: dict, run: str) -> None:
    want = PATH_LAUNCHES[run]
    got = {name: counts[name] for name in want}
    check(got == want, f"launches per {run}: {got}, expected {want}")


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


def msm_bound(dig: torch.Tensor) -> dict:
    """The bound of one msm_select_reduce over digits [m, n2, W]: the table,
    the digits and the sums moved once; an add for every nonzero digit (a
    zero digit selects infinity and needs none)."""
    m, n2, n_win = dig.shape
    n_bytes = (3 * 9 * m * n2 + 3 * m * n_win) * ELEM_BYTES + 4 * dig.numel()
    return bound(n_bytes, int((dig != 0).sum()) * PRODUCTS_ADD)


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


def ptxas_report(log: str) -> dict:
    """{function: {"registers", "stack", "spill_stores", "spill_loads"}}
    from an `nvcc -Xptxas -v` report, by mangled name."""
    out, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props:
            out.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def phase_build() -> None:
    from go_curdleproofs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build(force=True)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    log = (kernels.BUILD_DIR / "nvcc.log").read_text().strip()
    print(log)
    report = ptxas_report(log)
    for kernel in NO_STACK_KERNELS:
        # the mangled name carries the length of the plain one: 15mont_mul...
        # and not 18fr_mont_mul...
        hits = {f: r for f, r in report.items()
                if f"{len(kernel)}{kernel}" in f}
        check(len(hits) >= 1, f"ptxas reports {kernel}, saw {hits}")
        for f, r in sorted(hits.items()):
            check(r.get("stack") == 0 and r.get("spill_stores") == 0
                  and r.get("spill_loads") == 0,
                  f"{f}: no stack frame and no spills, saw {r}")
            print(f"ptxas: {f} {r['registers']} registers, "
                  f"{r['stack']} bytes stack, no spills")


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
    from go_curdleproofs_tpu_torch.time_kernels import MUL_SHAPES, card_ms
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    rng = random.Random(2024)
    res = {}
    W = curve.NUM_WINDOWS
    print("kernel vs plain: exact integer results, tolerance 0")

    def report(name, shape, err, ms, plain_ms, bnd, keep=True, what=""):
        print(f"{name} {shape}{what}: exact; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {bnd['bound_ms']:.6f} ms by "
              f"{bnd['bound_by']}")
        if keep:
            res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd)

    # B1: the beta multiply of a table's x plane (one element against
    # [9, 1, 2048]) and 2,048 elementwise products (the decoder's before
    # decode_points)
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

    # B1 at every batch the paths give it: both operands, the second one
    # element (the beta and plain-1 multiplies), the first one element, one
    # tensor as both; and above the grid-stride limit (132 * 16 blocks)
    for shape in MUL_SHAPES + [(132 * 16 * 64 + 37,)]:      # 135,205
        n = 1
        for d in shape:
            n *= d
        xs = fp.from_ints([rng.randrange(fh.P) for _ in range(min(n, 4096))],
                          dev)
        u = xs[torch.arange(n, device=dev) % xs.shape[0]].reshape(
            *shape, fp.NWORDS)
        v = u.flatten(0, -2).roll(5, 0).reshape(u.shape).contiguous()
        one = xs[-1].contiguous()
        for x, y, what in ((u, v, ""), (u, one, " x one element"),
                           (one, u, ", one element x"), (u, u, " squared")):
            check(torch.equal(kernels.mont_mul(x, y),
                              kernels.mont_mul_plain(x, y)),
                  f"mont_mul {list(shape)}{what}")
        if shape in MUL_SHAPES:
            on_card = card_ms(lambda: kernels.mont_mul(u, one),
                              "mont_mul_kernel")
            print(f"mont_mul {list(shape)} x one element: on the card "
                  f"{on_card:.4f} ms a launch")
    print(f"mont_mul at {[list(s) for s in MUL_SHAPES]} and "
          f"[{132 * 16 * 64 + 37}], each with both operands, one element on "
          f"either side and one tensor as both: exact against the plain "
          f"version")

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

    # B2 and B3: 1025 points, whose first lanes hold the corners of the
    # complete formulas; every batch below is a prefix of them
    pts = _curve_points(1025, rng)
    qts = _curve_points(1025, rng)
    pts[0] = None                              # infinity + Q
    qts[1] = None                              # P + infinity
    pts[2] = qts[2] = None                     # infinity + infinity
    qts[3] = pts[3]                            # P + P
    qts[4] = fh.g1_neg(pts[4])                 # P + (-P)
    pv_all = curve.from_affine_host(pts, device=dev)
    qv_all = curve.from_affine_host(qts, device=dev)

    def prefix(v, n):
        return curve.pmap(lambda t: t[:n].contiguous(), v)

    def check_point_op(name, args, want_aff, shape, keep):
        """The kernel against its plain version (words) and the host
        oracle (affine), then timed."""
        kernel = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        got = kernel(*args)
        err = _point_err(got, plain(*args))
        check(err == 0 and curve.to_affine_host(got) == want_aff,
              f"{name} {shape}")
        n = got.x.numel() // fp.NWORDS
        products, coords = ((PRODUCTS_ADD, 9) if len(args) == 2
                            else (PRODUCTS_DOUBLE, 6))
        report(name, shape, err, kernel_ms(lambda: kernel(*args)),
               cuda_ms(lambda: plain(*args)),
               bound(coords * n * ELEM_BYTES, n * products), keep=keep)
        on_card = card_ms(lambda: kernel(*args), name + "_kernel")
        print(f"{name} {shape}: on the card {on_card:.4f} ms a launch")

    # B3: the device prover's 1-24 points, the table build's [1024] row
    # (the widest shape on the paths), 1025 for a ragged last block
    for n in (1, 4, 24, 1024, 1025):
        check_point_op("point_double", (prefix(pv_all, n),),
                       [fh.g1_add(p, p) for p in pts[:n]], [n],
                       keep=n == 1024)

    # B2: the device prover's 1-24 points, the final MSM's [33] window
    # sums, 1025, and the table build's [4, 1, 1024]; each with P and Q
    # and with P as both operands (the same tensors)
    for n in (1, 2, 4, 7, 24, 33, 1025):
        pv, qv = prefix(pv_all, n), prefix(qv_all, n)
        check_point_op("point_add", (pv, qv),
                       [fh.g1_add(p, q) for p, q in zip(pts, qts[:n])], [n],
                       keep=False)
        same = kernels.point_add(pv, pv)
        check(_point_err(same, kernels.point_add_plain(pv, pv)) == 0
              and curve.to_affine_host(same)
              == [fh.g1_add(p, p) for p in pts[:n]],
              f"point_add(p, p) [{n}]")
    p4 = curve.pmap(lambda t: t.expand(4, 1, 1024, fp.NWORDS).contiguous(),
                    prefix(pv_all, 1024))
    q4 = curve.pmap(lambda t: torch.stack(
        [t, t.roll(1, 0), t.roll(2, 0), t.roll(3, 0)])[:, None].contiguous(),
        prefix(qv_all, 1024))
    q4_aff = [qts[(i - k) % 1024] for k in range(4) for i in range(1024)]
    check_point_op("point_add", (p4, q4),
                   [fh.g1_add(pts[i % 1024], q)
                    for i, q in enumerate(q4_aff)], [4, 1, 1024], keep=True)
    same = kernels.point_add(p4, p4)
    check(_point_err(same, kernels.point_add_plain(p4, p4)) == 0,
          "point_add(p, p) [4, 1, 1024]")
    print("point_add and point_double: the corners (infinity in either or "
          "both operands, P + P, P + (-P)) and P + P through one tensor "
          "exact against the plain versions and the host's group law")

    # B7: the sqrt ladder over 1024 lanes (the decoder's before
    # decode_points) and the provers'
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
               msm_bound(dig), keep=keep, what=what)
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

    # B5: final MSM Horner [33, 1], a ragged [33, 7], the old decode's subgroup
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


# decode_points at one point, a ragged 17, the two verify cells' decodes
# (585 and 2,141 points), the 248 of a prove and a 32-proof batch's ~18,720
DECODE_SIZES = (1, 17, 248, 585, 2141, 18720)
DECODE_TIMED = (585, 2141)


def decode_inputs(n: int, rng: random.Random):
    """n compressed points for decode_points: subgroup points of both signs,
    and every eighth (from the fourth on) one of: an x whose x^3 + 4 is no
    square, an on-curve point outside the subgroup (a fixed one plus a
    subgroup point), the order-3 point (0, +-2). Returns (x bytes [n, 48]
    with the flag bits cleared, signs [n], the expected flags, the expected
    y or None where x is off the curve)."""
    from go_curdleproofs_tpu_torch.utils import codec
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    p = fh.P
    bad = None
    while bad is None:
        x = rng.randrange(p)
        y = fh.fp_sqrt((x * x % p * x + 4) % p)
        if y is not None and not fh.g1_in_subgroup((x, y)):
            bad = (x, y)
    pts = _curve_points(n, rng)
    blobs, flags, ys = [], [], []
    for i, pt in enumerate(pts):
        kind = (i // 8) % 3 if i % 8 == 3 else None
        f = 3
        if kind == 0:
            b = bytearray(_off_curve_blob(rng))
            b[0] |= 0x20 if i & 16 else 0
            blobs.append(bytes(b))
            flags.append(None)
            ys.append(None)
            continue
        if kind == 1:
            pt, f = fh.g1_add(bad, pt), 1
        elif kind == 2:
            pt, f = (0, 2 if i & 16 else p - 2), 1
        blobs.append(codec.g1_to_bytes(pt))
        flags.append(f)
        ys.append(pt[1])
    xb = bytearray()
    for b in blobs:
        xb += bytes([b[0] & 0x1F]) + b[1:48]
    wl = [int(b[0] & 0xE0 == 0xA0) for b in blobs]
    return (torch.frombuffer(xb, dtype=torch.uint8).reshape(n, 48).clone(),
            torch.tensor(wl, dtype=torch.uint8), flags, ys)


def phase_decode(dev: torch.device) -> dict:
    """decode_points against its plain version on the card, word for word
    and flag for flag, at DECODE_SIZES; its flags and y against the host;
    timed by CUDA events and by the profiler at DECODE_TIMED beside the
    bound of benchmark/core/roofline.py (DECODE_MACS a point); then one
    batch_decompress of 585 points: one decode_points launch, no other
    kernel and one device-to-host copy. Runs first: the card's profiler
    stops reporting kernels after a few thousand in a process."""
    from benchmark.core import roofline
    from go_curdleproofs_tpu_torch.ops import codec_batch, kernels
    from go_curdleproofs_tpu_torch.time_kernels import card_ms
    from go_curdleproofs_tpu_torch.utils import codec
    from torch.profiler import ProfilerActivity, profile

    rng = random.Random(1818)
    res = {}
    for n in DECODE_SIZES:
        xb, wl, flags, ys = decode_inputs(n, rng)
        xb_d, wl_d = xb.to(dev), wl.to(dev)
        kernels.reset_launches()
        got = kernels.decode_points(xb_d, wl_d)
        torch.cuda.synchronize()
        check(kernels.launches["decode_points"] == 1, "one decode launch")
        t0 = time.perf_counter()
        want = kernels.decode_points_plain(xb_d, wl_d)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(got, want),
              f"decode_points [{n}] word for word against the plain version")
        host = got.cpu().numpy()
        for i, (f, y) in enumerate(zip(flags, ys)):
            check(f is None or int(host[i, 12]) == f,
                  f"decode_points [{n}] point {i}: flags {host[i, 12]}, "
                  f"expected {f}")
            check(f is not None or int(host[i, 12]) & 1 == 0,
                  f"decode_points [{n}] point {i} is off the curve")
            check(y is None or int.from_bytes(host[i, :12].tobytes(),
                                              "little") == y,
                  f"decode_points [{n}] point {i}: y")
        line = (f"decode_points [{n}]: exact against the plain version and "
                f"the host ({sum(f is None for f in flags)} off the curve, "
                f"{sum(f == 1 for f in flags)} outside the subgroup); plain "
                f"{plain_ms:.1f} ms")
        if n in DECODE_TIMED:
            ms = kernel_ms(lambda: kernels.decode_points(xb_d, wl_d), 10)
            on_card = card_ms(lambda: kernels.decode_points(xb_d, wl_d),
                              "decode_points_kernel", 10)
            bnd = roofline.bound_seconds({"decode": n}) * 1e3
            macs, nbytes = roofline.work_macs_bytes({"decode": n})
            by = ("operations" if macs / roofline.PEAK_MACS_PER_S
                  > nbytes / roofline.PEAK_BYTES_PER_S else "bytes")
            line += (f"; kernel {ms:.4f} ms (CUDA events), {on_card:.4f} ms "
                     f"a launch on the card (profiler), bound {bnd:.6f} ms "
                     f"by {by} ({100 * bnd / on_card:.2f}% of the roofline)")
            res["decode_points"] = dict(
                max_abs_err=0, ms=ms, card_ms=on_card, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, shape=[n])
        print(line, flush=True)

    # the path: one launch, one copy each way, no other kernel
    pts = _curve_points(585, rng)
    blobs = [codec.g1_to_bytes(p) for p in pts]
    check(codec_batch.batch_decompress(blobs, device=dev) == pts,
          "batch_decompress of 585 points")
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = codec_batch.batch_decompress(blobs, device=dev)
        torch.cuda.synchronize()
    check(got == pts, "batch_decompress of 585 points, profiled")
    counts = {k: v for k, v in kernels.launches.items() if v}
    check(counts == {"decode_points": 1},
          f"one decode_points launch a batch_decompress, saw {counts}")
    device = [e.key for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              for _ in range(e.count)]
    kernels_seen = [k for k in device
                    if not k.startswith(("Memcpy", "Memset"))]
    dtoh = [k for k in device if k.startswith("Memcpy DtoH")]
    check(len(kernels_seen) == 1 and "decode_points_kernel" in
          kernels_seen[0] and len(dtoh) == 1,
          f"batch_decompress on the card: one kernel, one DtoH copy; saw "
          f"{device}")
    order3 = codec.g1_to_bytes((0, 2))        # on the curve, order 3
    off_curve = _off_curve_blob(rng)
    for batch, err in (
            (blobs[:3] + [order3, off_curve] + blobs[3:5],
             "point not on curve"),
            (blobs[:3] + [order3], "point not in prime-order subgroup")):
        try:
            codec_batch.batch_decompress(batch, device=dev)
            check(False, f"{err} raised")
        except ValueError as e:
            check(str(e) == err, f"{err} raised, saw {e}")
    check(codec_batch.batch_decompress(blobs[:3] + [order3], device=dev,
                                       subgroup_check=False)
          == pts[:3] + [(0, 2)], "the order-3 point without the check")
    print(f"batch_decompress of 585 points on the card: {kernels_seen}, "
          f"{len(dtoh)} device-to-host copy; the device events {device}",
          flush=True)
    return res


def _off_curve_blob(rng: random.Random) -> bytes:
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    while True:
        x = rng.randrange(fh.P)
        if fh.fp_sqrt((x * x % fh.P * x + 4) % fh.P) is None:
            b = bytearray(x.to_bytes(48, "big"))
            b[0] |= 0x80
            return bytes(b)


def _long_label(n: int) -> bytes:
    return bytes((7 * i + 65) % 256 for i in range(n))


def _edge_starts(n: int) -> set:
    """Start positions at which the rate's last byte takes each kind of
    byte of a first header [pb_old, M|A, label (n bytes), 32, 0, 0, 0, pb,
    flag], at its first or second crossing."""
    return {(165 - e) % 166 for e in (0, 1, 2, n + 1, n + 2, n + 5, n + 6,
                                      n + 7)}


def _state_with_attempts(rng: random.Random, pos: int, pos_begin: int,
                         label: bytes, attempts: int) -> bytes:
    """A random STROBE state whose challenge under `label` at (pos,
    pos_begin) takes exactly `attempts` squeezes (each is rejected with
    probability 1 - r / 2^256, about 0.55)."""
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    from go_curdleproofs_tpu_torch.utils.transcript import Transcript

    for _ in range(1000):
        state = rng.randbytes(200)
        t = Transcript(b"chip_smoke")
        s = t.inner.strobe
        s.state[:], s.pos, s.pos_begin = state, pos, pos_begin
        n = 1
        while int.from_bytes(t.inner.challenge_bytes(label, 32),
                             "big") >= fh.R:
            n += 1
        if n == attempts:
            return state
    raise RuntimeError(f"no state with {attempts} attempts in 1000")


def phase_kernels_device_prover(dev: torch.device) -> dict:
    """The device prover's kernels vs their plain versions on the card, at
    that path's shapes, and the two forms of a per-point scalar
    multiplication side by side."""
    from go_curdleproofs_tpu_torch.models import device_common
    from go_curdleproofs_tpu_torch.ops import curve, fr, kernels, strobe_dev
    from go_curdleproofs_tpu_torch.time_kernels import card_ms
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    from go_curdleproofs_tpu_torch.utils.transcript import Transcript

    rng = random.Random(2025)
    res = {}

    def report(name, shape, ms, plain_ms, bnd, keep, what=""):
        print(f"{name} {shape}{what}: exact; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.2f} ms, bound {bnd['bound_ms']:.6f} ms by "
              f"{bnd['bound_by']}")
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

    # the same grid in launches of at most 512 elements, as the device
    # prove's, and every edge and raw word broadcast on either side of
    # [128] lanes
    ga, gb = _raw_fr(xs[:n_grid], dev), _raw_fr(ys[:n_grid], dev)
    for lo in range(0, n_grid, 512):
        hi = min(lo + 512, n_grid)
        part_a, part_b = ga[lo:hi], gb[lo:hi]
        got = kernels.fr_mont_mul(part_a, part_b)
        check(torch.equal(got, kernels.fr_mont_mul_plain(part_a, part_b))
              and _fr_values(got) == [u * v * r_inv % fh.R for u, v in
                                      zip(xs[lo:hi], ys[lo:hi])],
              f"fr_mont_mul edge grid, pairs {lo}-{hi - 1}")
    lanes = _raw_fr([rng.randrange(1 << 256) for _ in range(128)], dev)
    canon = fr.from_ints([rng.randrange(fh.R) for _ in range(128)], dev)
    for u in edge + raw:
        one = _raw_fr([u], dev)[0]
        check(torch.equal(kernels.fr_mont_mul(one, canon),
                          kernels.fr_mont_mul_plain(one, canon)),
              f"fr_mont_mul {u:#x} broadcast as the first operand")
        if u < fh.R:                    # the second operand is canonical
            check(torch.equal(kernels.fr_mont_mul(lanes, one),
                              kernels.fr_mont_mul_plain(lanes, one)),
                  f"fr_mont_mul {u:#x} broadcast as the second operand")
    print(f"fr_mont_mul: the edge grid ({n_grid} pairs) in "
          f"launches of 512, and {len(edge) + len(raw)} edge and raw words "
          f"broadcast on either side of [128] lanes (raw on the first side "
          f"only): exact against the plain version and Python ints")

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

    # the challenge from every start position, labels of 0, 9 and 32 bytes
    # (headers of 8-40 bytes: inside the rate, crossing it at each kind of
    # header byte, ending on it), at states that take 1, 2 and 3 attempts
    # (every retry re-enters at pos 32); pos_begin of each kind
    n_cases = 0
    for start in range(kernels.STROBE_R):
        kinds = (0, start, min(start + 1, kernels.STROBE_R), kernels.STROBE_R)
        for li, label in enumerate((b"", b"ipa_gamma", bytes(range(65, 97)))):
            for attempts in (1, 2, 3):
                pb = kinds[(li + attempts + start) % len(kinds)]
                state = _state_with_attempts(rng, start, pb, label, attempts)
                st = strobe_dev.bytes_tensor(state, dev)
                g_st, g_ch = kernels.strobe_challenge32(st, label, start, pb)
                w_st, w_ch = kernels.strobe_challenge32_plain(st, label,
                                                              start, pb)
                check(torch.equal(g_st, w_st) and torch.equal(g_ch, w_ch),
                      f"strobe_challenge32 from {start}, pos_begin {pb}, "
                      f"label of {len(label)} bytes, {attempts} attempts")
                n_cases += 1
    print(f"strobe_challenge32 from every start 0-165, labels of 0, 9 and 32 "
          f"bytes, 1, 2 and 3 attempts ({n_cases} cases): exact against the "
          f"plain version")

    # labels over 32 bytes (the long instantiation): on both sides of each
    # bound of the short design, from every eighth start, 0, 165 and the
    # starts where the rate's last byte takes each kind of header byte;
    # each challenge one launch of the kernel and nothing else
    n_cases, starts_seen = 0, set()
    for n in LONG_LABEL_LENS:
        label = _long_label(n)
        starts = sorted(set(range(0, kernels.STROBE_R, 8))
                        | {0, kernels.STROBE_R - 1} | _edge_starts(n))
        starts_seen |= set(starts)
        for start in starts:
            for attempts in (1, 2, 3):
                pb = rng.randrange(kernels.STROBE_R + 1)
                state = _state_with_attempts(rng, start, pb, label, attempts)
                st = strobe_dev.bytes_tensor(state, dev)
                before = dict(kernels.launches)
                g_st, g_ch = kernels.strobe_challenge32(st, label, start, pb)
                check(_launched_since(before) == {"strobe_challenge32": 1},
                      f"a label of {n} bytes is one strobe_challenge32 "
                      f"launch and nothing else")
                w_st, w_ch = kernels.strobe_challenge32_plain(st, label,
                                                              start, pb)
                check(torch.equal(g_st, w_st) and torch.equal(g_ch, w_ch),
                      f"strobe_challenge32 from {start}, pos_begin {pb}, "
                      f"label of {n} bytes, {attempts} attempts")
                n_cases += 1
    print(f"strobe_challenge32, labels of "
          f"{', '.join(map(str, LONG_LABEL_LENS))} bytes from "
          f"{len(starts_seen)} starts (every eighth, 0, 165 and the edges of "
          f"each label), 1, 2 and 3 attempts ({n_cases} cases): exact "
          f"against the plain version, each one strobe_challenge32 launch "
          f"and no strobe_absorb_stream launch")

    # timed at 1, 2 and 3 attempts from a mid-rate position, with the host
    # transcript beside it
    label, pos, pb = b"same_msm_gamma", 41, 3
    for attempts in (1, 2, 3):
        state = _state_with_attempts(rng, pos, pb, label, attempts)
        st = strobe_dev.bytes_tensor(state, dev)
        g_st, g_ch = kernels.strobe_challenge32(st, label, pos, pb)
        host = Transcript(b"chip_smoke")
        host.inner.strobe.state[:] = state
        host.inner.strobe.pos, host.inner.strobe.pos_begin = pos, pb
        c = host.get_and_append_challenge(label)
        check(int.from_bytes(bytes(g_ch.tolist()), "big") == c
              and bytes(g_st.tolist()) == bytes(host.inner.strobe.state),
              f"strobe_challenge32 at {attempts} attempts against the host "
              f"transcript")
        report("strobe_challenge32", f"{attempts} attempts",
               kernel_ms(lambda: kernels.strobe_challenge32(st, label, pos,
                                                            pb)),
               cuda_ms(lambda: kernels.strobe_challenge32_plain(
                   st, label, pos, pb), 1),
               bound(400 + 32 + len(label), attempts, KECCAK_INT32_OPS),
               keep=attempts == 2)
        on_card = card_ms(lambda: kernels.strobe_challenge32(st, label, pos,
                                                             pb),
                          "strobe_challenge32_kernel")
        print(f"strobe_challenge32 {attempts} attempts: on the card "
              f"{on_card:.4f} ms a launch")

    # the long path at 1 and 2 attempts from the same position, beside its
    # bounds: the serial chain (permutations x 2.48 us, the one-warp
    # permutation) and the roofline
    for n in (33, 127, 300):
        label = _long_label(n)
        for attempts in (1, 2):
            state = _state_with_attempts(rng, pos, pb, label, attempts)
            st = strobe_dev.bytes_tensor(state, dev)
            host = Transcript(b"chip_smoke")
            host.inner.strobe.state[:] = state
            host.inner.strobe.pos, host.inner.strobe.pos_begin = pos, pb
            c = host.get_and_append_challenge(label)
            g_st, g_ch = kernels.strobe_challenge32(st, label, pos, pb)
            check(int.from_bytes(bytes(g_ch.tolist()), "big") == c
                  and bytes(g_st.tolist()) == bytes(host.inner.strobe.state),
                  f"strobe_challenge32, label of {n} bytes, {attempts} "
                  f"attempts, against the host transcript")
            perms = _challenge_perms(state, label, pos, pb)

            def fn():
                return kernels.strobe_challenge32(st, label, pos, pb)

            report("strobe_challenge32", f"label of {n} bytes, {attempts} "
                   f"attempts", kernel_ms(fn),
                   cuda_ms(lambda: kernels.strobe_challenge32_plain(
                       st, label, pos, pb), 1),
                   bound(400 + 32 + n, perms, KECCAK_INT32_OPS), keep=False)
            on_card = card_ms(fn, "strobe_challenge32_kernel")
            print(f"strobe_challenge32 label of {n} bytes, {attempts} "
                  f"attempts: on the card {on_card:.4f} ms a launch, "
                  f"{perms} permutations, chain bound "
                  f"{perms * PERMUTATION_US / 1e3:.4f} ms")
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
    check_path_launches(kernels.launches, "verify")
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
    check_path_launches(counts, "prove")
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


def check_graph_proves(prove, proof: bytes, chain_launched: list,
                       seen: dict):
    """The three device proves after the eager one, with the spans on: the
    first captures the chain into a CUDA graph and replays it, the second
    and third replay it, the third under torch.profiler (after a replay
    in the profiler's warm-up step). Each is
    byte-identical to the eager prove, one chain span counting one replay
    and the eager chain's kernels, one fetch; the capture's wrappers
    launch each kernel as the eager chain's did (`chain_launched[-1]`,
    by kernel); the replays hold only the spans outside the chain and
    run `_chain` not at all. What the profiled replay ran on the card,
    each hand-written kernel counted by name in the card's events, less
    what its wrappers launched outside the chain, is the eager chain's
    launches, kernel for kernel. Returns the first two proves' ms and the
    profiled replay's kernels on the card."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from go_curdleproofs_tpu_torch.ops import kernels
    from go_curdleproofs_tpu_torch.utils import profiling

    eager = chain_launched[-1]
    walls, traced = [], None
    for run in ("capture", "replay", "profiled replay"):
        seen.update(chains=0, fetches=0)
        kernels.reset_launches()
        profiling.reset()
        profiling.enable()
        t0 = time.perf_counter()
        try:
            if run == "profiled replay":
                # a first replay in the profiler's warm-up step, traced and
                # discarded: late in a long process a profiler can miss the
                # first kernels it should record
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             schedule=schedule(wait=0, warmup=1, active=1,
                                               repeat=1)) as prof:
                    prove()
                    torch.cuda.synchronize()
                    prof.step()
                    seen.update(chains=0, fetches=0)
                    kernels.reset_launches()
                    profiling.reset()
                    _, got = prove()
                    torch.cuda.synchronize()
                    prof.step()
                traced = kernels.traced_launches(prof.key_averages())
            else:
                _, got = prove()
                torch.cuda.synchronize()
        finally:
            profiling.disable()
        walls.append((time.perf_counter() - t0) * 1e3)
        chains = [r.counts for r in profiling.records() if r.name == "chain"]
        spans = set(profiling.totals())
        check(got == proof, f"the device prove's {run} byte-identical to the "
              f"eager prove")
        check(chains == [{"chain.replays": 1,
                          "chain.kernels": sum(eager.values())}],
              f"the {run}'s chain span counts {chains}")
        check(seen == dict(chains=int(run == "capture"), fetches=1),
              f"the {run}: one fetch, a chain only in the capture, saw {seen}")
        check(run != "capture" or chain_launched[-1] == eager,
              f"the capture's chain launches {chain_launched[-1]}")
        inner = set(DEVICE_PROVE_SPANS) - set(DEVICE_REPLAY_SPANS)
        check(set(DEVICE_REPLAY_SPANS) <= spans
              and (run == "capture" or not spans & inner),
              f"the {run}'s spans, saw {sorted(spans)}")
    profiling.reset()
    on_card = {k: n - kernels.launches[k] for k, n in traced.items()}
    check(on_card == eager and all(on_card[k] == n for k, n
                                   in DEVICE_PROVE_LAUNCHES.items()),
          f"the replayed chain's kernels on the card "
          f"{on_card} (profiler, less the wrappers' {dict(kernels.launches)}"
          f"), the eager chain's launches {eager}")
    print(f"device prove by the graph: capture {walls[0]:.1f} ms, replay "
          f"{walls[1]:.1f} ms, byte-identical, chain.kernels "
          f"{sum(eager.values())}; the replayed chain's kernels on the card "
          f"(profiler) {on_card}, the eager chain's launches")
    return walls[:2], traced


def phase_device_prover(dev: torch.device, card: str, crs, insts, gv,
                        host_post, host_proof: bytes, host_ms) -> dict:
    """The device-resident one-fetch prover on the card. Returns the
    launch counts of one ELL=124 device prove by the CUDA graph, read
    from the card's events."""
    from go_curdleproofs_tpu_torch.models import (curdleproof,
                                                  device_common,
                                                  device_prover_full, whisk)
    from go_curdleproofs_tpu_torch.ops import kernels
    from go_curdleproofs_tpu_torch.utils import profiling
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    # From here on the chain between the upload and the one fetch runs
    # with synchronising calls turned into errors, and every fetch counts.
    chain, fetch = device_prover_full._chain, device_common.fetch
    seen = dict(chains=0, fetches=0)
    chain_launched = []         # each `_chain` run's wrapper launches

    def guarded_chain(inp):
        seen["chains"] += 1
        before = dict(kernels.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return chain(inp)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            chain_launched.append({k: n - before[k]
                                   for k, n in kernels.launches.items()})

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

        # the counted prove runs with the spans on: the ones inside the
        # chain run under sync-debug "error" with it
        seen.update(chains=0, fetches=0)
        kernels.reset_launches()
        profiling.reset()
        profiling.enable()
        t0 = time.perf_counter()
        try:
            with MulShapes("fr_mont_mul") as fr_sizes:
                post, proof = prove()
            torch.cuda.synchronize()
        finally:
            profiling.disable()
        cold_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(kernels.launches)
        spans = profiling.totals()
        check(set(DEVICE_PROVE_SPANS) <= set(spans),
              f"the device prove's spans, saw {sorted(spans)}")
        # every launch of the device-only kernels is inside the chain, and
        # the shuffle's are outside it
        records = profiling.records()
        in_chain = [r.counts["chain.kernels"] for r in records
                    if r.name == "chain"]
        check(len(in_chain) == 1 and sum(DEVICE_PROVE_LAUNCHES.values())
              <= in_chain[0] < sum(counts.values()),
              f"chain.kernels {in_chain} of {sum(counts.values())} launches")
        print("spans of the device prove (profiling.enable(), host clock):")
        print(profiling.report())
        profiling.reset()
        check(seen == dict(chains=1, fetches=1),
              f"one chain and one fetch per device prove, saw {seen}")
        check([r.counts.get("chain.replays") for r in records
               if r.name == "chain"] == [0], "the first prove runs eagerly")
        check(sum(chain_launched[-1].values()) == in_chain[0],
              f"the eager chain's launches {chain_launched[-1]}")
        replay_ms, replay_counts = check_graph_proves(prove, proof,
                                                      chain_launched, seen)
        check(proof == host_proof and
              [(t.r_g, t.k_r_g) for t in post]
              == [(t.r_g, t.k_r_g) for t in host_post],
              "ELL=124 prover=device proof byte-identical to prover=host")
        for name, n in counts.items():
            check(n > 0, f"{name} launched by the device prove")
        check_path_launches(counts, "device prove")
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
    check_fr_mul_sizes(dev, fr_sizes.hist)
    print("no synchronising call between upload and the one fetch "
          "(chain run under set_sync_debug_mode('error'))")
    print(f"device prove ELL=124: cold {cold_ms:.1f} ms (eager chain), "
          f"capture and replay {replay_ms[0]:.1f} ms, replay "
          f"{replay_ms[1]:.1f} ms, warm {dev_warm:.1f} ms (median of 5 "
          f"replays); host prove: cold {host_ms[0]:.1f} ms, warm "
          f"{host_ms[1]:.1f} ms earlier, {host_warm[0]:.1f} and "
          f"{host_warm[1]:.1f} ms around the device runs; on {card}; "
          f"byte-identical proofs, verified, flipped byte rejected; "
          f"launches per device prove (a replay's, profiler) "
          f"{replay_counts}")
    return replay_counts


def check_fr_mul_sizes(dev: torch.device, hist: dict) -> None:
    """fr_mont_mul at every batch size of the device prove's histogram
    {elements: launches}: raw first operands against canonical ones, as
    pairs and with one element broadcast on either side, exact against the
    plain version, each with its time a launch on the card."""
    from go_curdleproofs_tpu_torch.ops import fr, kernels
    from go_curdleproofs_tpu_torch.time_kernels import card_ms
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    rng = random.Random(157)
    print(f"fr_mont_mul elements a launch in the device prove: "
          f"{dict(sorted(hist.items()))}")
    for n in sorted(hist):
        a = _raw_fr([rng.randrange(1 << 256) for _ in range(n)], dev)
        b = fr.from_ints([rng.randrange(fh.R) for _ in range(n)], dev)
        one_raw, one = a[0].contiguous(), b[-1].contiguous()
        for x, y, what in ((a, b, "pairs"), (a, one, "x one element"),
                           (one_raw, b, "one raw element x")):
            check(torch.equal(kernels.fr_mont_mul(x, y),
                              kernels.fr_mont_mul_plain(x, y)),
                  f"fr_mont_mul [{n}] {what}")
        pairs, bcast = (card_ms(lambda: kernels.fr_mont_mul(x, y),
                                "fr_mont_mul_kernel")
                        for x, y in ((a, b), (a, one)))
        print(f"fr_mont_mul [{n}] ({hist[n]} launches): exact as pairs and "
              f"broadcast either side; on the card {pairs:.5f} ms a launch "
              f"(pairs), {bcast:.5f} (x one element)")


# the kernels of a batch verify, held against their plain versions at the
# inputs the b32 verify gave them
BATCH_KERNELS = ("mont_mul", "point_add", "point_double", "decode_points",
                 "windowed_combine", "msm_select_reduce")


def _shape_key(x):
    """A hashable description of one argument: a tensor's shape, the
    shapes of a tuple of tensors, a list's length, or the value."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    if isinstance(x, (tuple, list)) and x and isinstance(x[0], torch.Tensor):
        return tuple(_shape_key(t) for t in x)
    if isinstance(x, (tuple, list)):
        return len(x)
    return x


def _copy(x):
    """x with every tensor in it cloned (named tuples keep their type)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_copy, x))
    if isinstance(x, (tuple, list)):
        return type(x)(map(_copy, x))
    return x


class CallInputs:
    """While entered, keeps a copy of the arguments of the first call of
    each argument shape to each (module, name) function: {(name, shapes):
    (args, kwargs)}. The calls themselves run as before, so a wrapper's
    launch count is its own."""

    def __init__(self, targets):
        self.targets = targets
        self.calls = {}

    def __enter__(self):
        self._saved = [(mod, name, getattr(mod, name))
                       for mod, name in self.targets]
        for mod, name, fn in self._saved:
            def recorded(*args, _name=name, _fn=fn, **kw):
                key = (_name, tuple(map(_shape_key, args)))
                if key not in self.calls:
                    self.calls[key] = (_copy(args), dict(kw))
                return _fn(*args, **kw)
            setattr(mod, name, recorded)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


class MulShapes:
    """Counts the elements of every launch of a multiply wrapper
    (`mont_mul` or `fr_mont_mul`, by its output) while it is entered:
    {elements: launches}."""

    def __init__(self, name: str):
        self.name = name
        self.hist = collections.defaultdict(int)

    def __enter__(self):
        from go_curdleproofs_tpu_torch.ops import kernels

        self._saved = getattr(kernels, self.name)

        def counted(a, b):
            out = self._saved(a, b)
            self.hist[out.numel() // out.shape[-1]] += 1
            return out
        setattr(kernels, self.name, counted)
        return self

    def __exit__(self, *exc):
        from go_curdleproofs_tpu_torch.ops import kernels

        setattr(kernels, self.name, self._saved)


def _challenge_perms(state: bytes, label: bytes, pos: int, pb: int) -> int:
    """Keccak-f permutations that get_and_append_challenge(label) takes from
    this STROBE state: a host replica through Merlin, counted."""
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    from go_curdleproofs_tpu_torch.utils.merlin import MerlinTranscript
    from go_curdleproofs_tpu_torch.utils.strobe import Strobe128

    h = Strobe128.__new__(Strobe128)
    h.state, h.pos, h.pos_begin, h.cur_flags = bytearray(state), pos, pb, 0
    m = MerlinTranscript.__new__(MerlinTranscript)
    m.strobe = h
    seen = [0]
    run_f = Strobe128._run_f

    def counted(self):
        seen[0] += 1
        run_f(self)

    Strobe128._run_f = counted
    try:
        chal = m.challenge_bytes(label, 32)
        while int.from_bytes(chal, "big") >= fh.R:
            chal = m.challenge_bytes(label, 32)
        m.append_message(label, chal)
    finally:
        Strobe128._run_f = run_f
    return seen[0]


def call_bound(name: str, args, kw) -> dict:
    """The bound of one launch of kernel `name` on these inputs."""
    from go_curdleproofs_tpu_torch.ops import kernels

    if name == "mont_mul":
        a, b = args
        n = max(a.numel(), b.numel()) // 12
        return bound((a.numel() + b.numel()) * 4 + n * ELEM_BYTES, n)
    if name in ("point_add", "point_double"):
        n = args[0].x.numel() // 12
        ins = 6 if name == "point_add" else 3
        return bound((ins + 3) * n * ELEM_BYTES, n * (
            PRODUCTS_ADD if name == "point_add" else PRODUCTS_DOUBLE))
    if name == "pow_fixed":
        x, e = args
        n, (n_sqr, n_mul) = x.numel() // 12, ladder_steps(e)
        return bound(2 * n * ELEM_BYTES, n * (
            n_mul + n_sqr * MADS_PER_SQUARE / MADS_PER_PRODUCT))
    if name == "windowed_combine":
        n_win, rows = args[0].x.shape[:2]
        return bound(3 * (n_win + 1) * rows * ELEM_BYTES, rows * n_win
                     * (4 * PRODUCTS_DOUBLE + PRODUCTS_ADD))
    if name == "msm_select_reduce":
        return msm_bound(args[1])
    if name == "decode_points":
        from benchmark.core import roofline
        seconds = roofline.bound_seconds({"decode": args[0].shape[0]})
        return dict(bound_ms=seconds * 1e3, bound_by="operations")
    if name == "strobe_absorb_stream":
        state, stream, pos, pbs = args[:4]
        final_pb = args[4] if len(args) > 4 else kw.get("final_pb")
        perms = pbs.numel() + int(final_pb is not None and
                                  (pos + stream.numel()) % kernels.STROBE_R)
        return bound(400 + stream.numel() + pbs.numel(), perms,
                     KECCAK_INT32_OPS)
    if name == "strobe_challenge32":
        state, label, pos, pb = args
        return bound(400 + 32 + len(label), _challenge_perms(
            bytes(state.tolist()), label, pos, pb), KECCAK_INT32_OPS)
    raise ValueError(name)


def check_recorded_kernels(calls: dict, names, where: str) -> dict:
    """Each kernel of `names` on the inputs it was given (one launch a
    recorded shape), exact against its plain version on the same inputs
    (msm_select_reduce by affine value: it sums in another order), with
    its time by CUDA events over 5 launches once for each shape of
    tensors (under ~0.03 ms they read the wrapper), the plain version's
    (host clock, synchronised) and the bound. (The card's profiler stops
    reporting kernels after a few thousand in a process, which phases 3-6
    use up: time_kernels.py gives the time a launch on the card at these
    shapes in a fresh process.) Returns {name: recorded shapes}."""
    from go_curdleproofs_tpu_torch.ops import curve, kernels

    runs, timed = [], {}
    for (name, key), (args, kw) in calls.items():
        if name not in names:
            continue
        fn = getattr(kernels, name)
        runs.append((name, key, args, kw, fn(*args, **kw)))
        tensors = tuple(k for k in key if isinstance(k, tuple))
        timed.setdefault((name, tensors),
                         lambda fn=fn, args=args, kw=kw: fn(*args, **kw))
    events = {k: kernel_ms(fn, 5) for k, fn in timed.items()}
    # windowed_combine's plain version takes as long at 1 row as at
    # thousands (a chain of ~165 plain point operations): its recorded
    # calls share one plain run over their rows side by side
    wc = [args[0] for name, _, args, _, _ in runs
          if name == "windowed_combine"]
    if wc:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        joint = kernels.windowed_combine_plain(curve.PointVec(
            *(torch.cat([sel[c] for sel in wc], dim=1) for c in range(3))))
        torch.cuda.synchronize()
        wc_ms = (time.perf_counter() - t0) * 1e3
        bounds = [0]
        for sel in wc:
            bounds.append(bounds[-1] + sel.x.shape[1])
        wc_want = [curve.pmap(lambda t, a=a, b=b: t[a:b], joint)
                   for a, b in zip(bounds, bounds[1:])]
    seen = {}
    for name, key, args, kw, got in runs:
        seen[name] = seen.get(name, 0) + 1
        if name == "windowed_combine":
            want, plain_ms = wc_want.pop(0), wc_ms
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = getattr(kernels, name + "_plain")(*args, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        if isinstance(got, torch.Tensor):
            err = 0 if torch.equal(got, want) else 1
        elif name == "msm_select_reduce":
            err = _affine_err(curve.to_affine_host(got),
                              curve.to_affine_host(want))
        elif name == "strobe_challenge32":
            err = 0 if all(map(torch.equal, got, want)) else 1
        else:
            err = _point_err(got, want)
        shapes = [k if isinstance(k, tuple) or not isinstance(k, int)
                  or name.startswith("strobe") else
                  f"{k.bit_length()}-bit exponent" for k in key]
        check(err == 0, f"{name} {shapes} at {where}'s inputs")
        tkey = (name, tuple(k for k in key if isinstance(k, tuple)))
        ev = events.pop(tkey, None)
        if ev is None:
            continue
        bnd = call_bound(name, args, kw)
        print(f"{name} {shapes} as {where} gave it: exact against the plain "
              f"version; {ev:.4f} ms a launch (CUDA events)"
              f", bound {bnd['bound_ms']:.3g} ms by {bnd['bound_by']}, "
              f"plain {plain_ms:.1f} ms"
              + (f" (one run for the {len(wc)} recorded shapes)"
                 if name == "windowed_combine" else ""))
    check(set(seen) == set(names),
          f"inputs of {sorted(set(names) - set(seen))} not recorded")
    return seen


def check_batch_msm(calls: dict, b: int, dev: torch.device, group) -> None:
    """The batch's final MSM again on its own bases, with the scalars of
    its first, middle and last base moved by k1, k2, k3: the honest sum is
    infinity, so the result must be k1*P1 + k2*P2 + k3*P3 (host group
    law). Its rows of bases, the tree that adds them and the Horner tail
    all take part."""
    from go_curdleproofs_tpu_torch.ops import curve
    from go_curdleproofs_tpu_torch.parallel import msm as pmsm
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    (bases, scalars), _ = next(v for (name, _), v in calls.items()
                               if name == "sharded_msm")
    rng = random.Random(b)
    moved = list(scalars)
    want = None
    for j in (0, len(bases) // 2, len(bases) - 1):
        k = rng.randrange(1, fh.R)
        moved[j] += k
        want = fh.g1_add(want, fh.g1_mul(bases[j], k))
    got = pmsm.sharded_msm(bases, moved, device=dev, group=group)
    check(want is not None and got == want,
          f"the b{b} batch's final MSM ({len(bases)} bases) with three "
          f"scalars moved")
    rows, width = curve._dynamic_layout(len(bases))
    print(f"b{b} final MSM, {len(bases)} bases in {rows} rows of {width}: "
          f"with three scalars moved by k1, k2, k3 it equals k1*P1 + k2*P2 "
          f"+ k3*P3 on the host")


def chained_proofs(crs, pre, count: int, *, device: torch.device,
                   seed: int = 0xBA7C) -> list:
    """`count` distinct Whisk shuffle proofs from the host prover, each
    shuffling the previous one's post-trackers (as block after block does):
    [(pre, post, proof bytes)]; proof i from Rand(seed + i)."""
    from go_curdleproofs_tpu_torch.models import whisk
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    out = []
    for i in range(count):
        post, proof = whisk.generate_whisk_shuffle_proof(
            crs, pre, Rand(seed + i), device=device)
        out.append((pre, post, proof))
        pre = post
    return out


def phase_batch_verify(dev: torch.device, card: str, crs, insts) -> dict:
    """Batched verification (parallel/) on the card with a one-rank NCCL
    group made from a FileStore: the dry run, then batches of 2 (the
    fixture), 8 and 32 distinct ELL=124 proofs accepted, each with one
    tampered proof rejected, their launch counts pinned, warm batch ms and
    proofs/s beside the same proofs verified one by one. Returns the launch
    counts of the b2, b8 and b32 batch verifies, summed."""
    import tempfile

    import torch.distributed as dist

    from go_curdleproofs_tpu_torch.models import whisk
    from go_curdleproofs_tpu_torch.ops import kernels
    from go_curdleproofs_tpu_torch.parallel import batch as pbatch
    from go_curdleproofs_tpu_torch.parallel import dryrun
    from go_curdleproofs_tpu_torch.parallel import msm as pmsm
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    t0 = time.perf_counter()
    chain = chained_proofs(crs, insts[0][0], max(BATCH_SIZES), device=dev)
    print(f"{len(chain)} chained proofs from the host prover: "
          f"{time.perf_counter() - t0:.1f} s")
    check(len({proof for _, _, proof in chain}) == len(chain),
          "distinct proofs")
    batches = {len(insts): list(insts)}
    batches.update((b, chain[:b]) for b in BATCH_SIZES)
    torch.cuda.set_device(dev)
    total = dict.fromkeys(kernels.launches, 0)
    with tempfile.TemporaryDirectory() as tmp:
        group = pmsm.init_file_group(os.path.join(tmp, "store"), rank=0,
                                     world_size=1, backend="nccl")
        try:
            t0 = time.perf_counter()
            dryrun.dryrun(crs, insts, device=dev, group=group)
            torch.cuda.synchronize()
            print(f"dry run: 1,024-base sharded MSM equals fh.g1_msm, both "
                  f"ELL=124 fixture proofs accepted through "
                  f"verify_shuffle_proofs_batch on a one-rank NCCL group "
                  f"({time.perf_counter() - t0:.1f} s)")

            def verify(batch, grp=group):
                return pbatch.verify_shuffle_proofs_batch(
                    crs, batch, Rand(9), device=dev, group=grp)

            for b, batch in batches.items():
                record = (CallInputs([(kernels, n) for n in BATCH_KERNELS]
                                     + [(pmsm, "sharded_msm")])
                          if b == max(BATCH_SIZES)
                          else contextlib.nullcontext())
                kernels.reset_launches()
                with record:
                    check(verify(batch), f"batch of {b} accepted")
                torch.cuda.synchronize()
                counts = dict(kernels.launches)
                for name in EARLIER_KERNELS:
                    check(counts[name] > 0,
                          f"{name} launched by the b{b} batch verify")
                check(counts == BATCH_LAUNCHES[b],
                      f"launches of a b{b} batch verify: {counts}, expected "
                      f"{BATCH_LAUNCHES[b]}")
                for name, n in counts.items():
                    total[name] += n
                pre, post, proof = batch[b // 2]
                bad = bytearray(proof)
                bad[SMS_FLIP_BYTE] ^= 0x01
                tampered = list(batch)
                tampered[b // 2] = (pre, post, bytes(bad))
                check(not verify(tampered),
                      f"batch of {b} with one tampered proof rejected")
                warm = cuda_ms(lambda: check(verify(batch), "warm batch"))
                alone = cuda_ms(lambda: check(verify(batch, None),
                                              "warm batch, no group"))
                singles = cuda_ms(lambda: check(all(
                    whisk.is_valid_whisk_shuffle_proof(
                        crs, *inst, Rand(7), device=dev) for inst in batch),
                    "single verifies"), 1)
                print(f"batch verify b{b}: warm {warm:.1f} ms "
                      f"({b / warm * 1e3:.1f} proofs/s) on the group, "
                      f"{alone:.1f} ms with no group (the static CRS row "
                      f"off its table); {b} single verifies {singles:.1f} "
                      f"ms ({b / singles * 1e3:.1f} proofs/s); tampered "
                      f"batch rejected; launches {counts}; on {card}")
                if b == max(BATCH_SIZES):
                    check_recorded_kernels(record.calls, BATCH_KERNELS,
                                           f"the b{b} batch verify")
                    check_batch_msm(record.calls, b, dev, group)
        finally:
            dist.destroy_process_group()
    return total


# -- phase 8: physical folding, the device MSM entry points, SState, ELL=252
# and ELL=508

# wrapper calls of one fold round and of one msm_device (every other
# kernel 0): the table of the h points to multiply (a double, two adds,
# the beta product), the Horner, the GLV halves' add and the fold's add
FOLD_ROUND_LAUNCHES = dict(point_add=4, point_double=1, mont_mul=1,
                           windowed_combine=1)
MSM_DEVICE_LAUNCHES = dict(point_add=2, point_double=1, mont_mul=1,
                           msm_select_reduce=1, windowed_combine=1)
FOLD_KERNELS = ("mont_mul", "point_add", "point_double", "windowed_combine",
                "msm_select_reduce", "strobe_absorb_stream",
                "strobe_challenge32")
ELL_BIG = 508              # bench.py's headline size: n = 512
ELL_MID = 252              # bench.py's size below it: n = 256
CRS_SEED = 0xC0FFEE        # bench.py's CRS seed
TRACKER_SEED = 0x508
FOLD_SEED = 0xF01D         # Rand seed of the fold gammas and MSM scalars
# the merlin crate's test vector: "test protocol", "some label" / "some
# data", then 32 challenge bytes under "challenge"
MERLIN_VECTOR = ("d5a21972d0d5fe320c0d263fac7fffb8"
                 "145aa640af6e9bca177c03c7efcf0615")
# the chained challenges of check_sstate: 6 under the protocol's kind of
# label, then 3 under labels over 32 bytes
CHALLENGE_LABELS = [b"c"] * 6 + [bytes(range(33)), b"l" * 127, b"m" * 300]


@contextlib.contextmanager
def sync_free():
    """A synchronising call inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _launched_since(before: dict) -> dict:
    from go_curdleproofs_tpu_torch.ops import kernels

    return {k: n - before[k] for k, n in kernels.launches.items()
            if n != before[k]}


def phase_ell(dev: torch.device, card: str, ell: int):
    """One Whisk shuffle at `ell` trackers (bench.py's sizes: 252 and 508,
    n = 256 and 512): the CRS from bench.py's seed, the trackers made on
    the card in one batch_scalar_mul, one prove with prover="host"
    verified, a flipped byte rejected, prover="device" from the same seeds
    byte for byte the same; cold and warm times and launch counts.
    Returns (the CRS, n of the trackers' points, launch counts of the
    first prove, verify and device prove)."""
    from go_curdleproofs_tpu_torch.models import curdleproof, whisk
    from go_curdleproofs_tpu_torch.ops import curve, kernels
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    t0 = time.perf_counter()
    crs = curdleproof.generate_crs(ell, Rand(CRS_SEED), device=dev)
    r = Rand(TRACKER_SEED)
    rs, ks = r.get_frs(ell), r.get_frs(ell)
    scalars = rs + [a * b % fh.R for a, b in zip(rs, ks)]
    pts = curve.batch_scalar_mul([fh.G1_GEN] * (2 * ell), scalars,
                                 device=dev)
    pre = [whisk.WhiskTracker.from_points(pts[i], pts[ell + i])
           for i in range(ell)]
    check(all(p == fh.g1_mul(fh.G1_GEN, x) for p, x in
              zip(pts[::127], scalars[::127])), "trackers on the card")
    print(f"ELL={ell}: CRS and {ell} trackers ({2 * ell} points "
          f"in one batch_scalar_mul) in {time.perf_counter() - t0:.1f} s")

    def prove(prover):
        return whisk.generate_whisk_shuffle_proof(
            crs, pre, Rand(PROVE_SEED), device=dev, prover=prover)

    def verify(post, proof):
        return whisk.is_valid_whisk_shuffle_proof(crs, pre, post, proof,
                                                  Rand(11), device=dev)

    total = dict.fromkeys(kernels.launches, 0)

    def counted(what, fn):
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(kernels.launches)
        for k, n in counts.items():
            total[k] += n
        print(f"ELL={ell} {what}: cold {ms:.1f} ms; launches "
              f"{ {k: n for k, n in counts.items() if n} }")
        return out

    post, proof = counted("prove (host)", lambda: prove("host"))
    check(len(proof) == whisk.expected_shuffle_proof_size(ell),
          f"ELL={ell} proof of {len(proof)} bytes")
    check(counted("verify", lambda: verify(post, proof)),
          f"ELL={ell} proof accepted")
    bad = bytearray(proof)
    bad[-20] ^= 0x01           # inside the same-multiscalar scalar x
    check(not verify(post, bytes(bad)), f"ELL={ell} flipped byte rejected")
    dpost, dproof = counted("prove (device)", lambda: prove("device"))
    check(dproof == proof and [(t.r_g, t.k_r_g) for t in dpost]
          == [(t.r_g, t.k_r_g) for t in post],
          f"ELL={ell} prover=device byte-identical to prover=host")
    host_ms = cuda_ms(lambda: prove("host"), 2)
    dev_ms = cuda_ms(lambda: check(prove("device")[1] == proof,
                                   "device prove repeats"), 2)
    ver_ms = cuda_ms(lambda: check(verify(post, proof), "warm verify"))
    print(f"ELL={ell} ({len(proof)} bytes): proof verified, flipped byte "
          f"rejected, prover=device byte-identical; warm host prove "
          f"{host_ms:.1f} ms, device prove {dev_ms:.1f} ms (median of 2), "
          f"verify {ver_ms:.1f} ms (median of 3) on {card}")
    return crs, pts[:ell + 4], total


def check_msm_entry_points(dev: torch.device) -> None:
    """msm_device at __graft_entry__.entry()'s inputs (rebuilt here: 128
    multiples of G below 2^30 and 62-bit scalars from numpy's seed 0),
    its launches pinned, under sync-debug "error"; msm_windows_device's
    sums combined on the host; N=512 with full-range scalars; two leading
    batch dims; msm_stacked_device and msm_rows_device at k=3, n=512, m=4
    and k=2, n=128, every (job, base) pair against the oracle."""
    import numpy as np

    from go_curdleproofs_tpu_torch.ops import curve, kernels
    from go_curdleproofs_tpu_torch.utils import field_host as fh

    def digits(rows):
        return curve._digits(np.stack([curve.scalars_to_digits(r)
                                       for r in rows]), dev)

    rng = np.random.default_rng(0)
    pts = [fh.g1_mul(fh.G1_GEN, int(k)) for k in rng.integers(1, 2**30, 128)]
    scalars = [int(x) for x in rng.integers(1, 2**62, 128)]
    pv = curve.from_affine_host(pts, device=dev)
    dig = digits([scalars])[0]
    before = dict(kernels.launches)
    with sync_free():
        out = curve.msm_device(pv, dig)
    one = _launched_since(before)
    check(one == MSM_DEVICE_LAUNCHES, f"launches of one msm_device: {one}")
    want = fh.g1_msm(pts, scalars)
    check(curve.to_affine_host_single(out) == want,
          "msm_device at the graft entry's inputs")
    with sync_free():
        wins = curve.msm_windows_device(pv, dig)
    check(fh.g1_combine_windows(curve.to_affine_host(wins),
                                curve.WINDOW_BITS) == want,
          "msm_windows_device's sums combined on the host")
    print(f"msm_device at the graft entry's inputs (n=128, 62-bit scalars) "
          f"equals fh.g1_msm, launches {one}; msm_windows_device's 33 sums "
          f"combined on the host the same")

    prng = random.Random(512)
    full = lambda n: [prng.randrange(fh.R) for _ in range(n)]  # noqa: E731
    p512 = _curve_points(512, prng)
    s512 = full(512)
    with sync_free():
        out = curve.msm_device(curve.from_affine_host(p512, device=dev),
                               digits([s512])[0])
    check(curve.to_affine_host_single(out) == fh.g1_msm(p512, s512),
          "msm_device N=512, full-range scalars")
    p6 = _curve_points(6 * 128, prng)
    s6 = [full(128) for _ in range(6)]
    pv6 = curve.pmap(lambda t: t.reshape(2, 3, 128, 12),
                     curve.from_affine_host(p6, device=dev))
    with sync_free():
        out = curve.msm_device(pv6, digits(s6).reshape(2, 3, 256, -1))
    check(curve.to_affine_host(out) == [fh.g1_msm(p6[128 * j:128 * j + 128],
                                                  s6[j]) for j in range(6)],
          "msm_device over [2, 3, 128]")
    print("msm_device at N=512 (full-range scalars) and over two leading "
          "batch dims [2, 3, 128]: equal to fh.g1_msm")

    for k, n, m in ((3, 512, 4), (2, 128, 2)):
        rows = [_curve_points(n, prng) for _ in range(k)]
        scs = [[full(n) for _ in range(k)] for _ in range(m)]
        pv = curve.pmap(lambda t: t.reshape(k, n, 12),
                        curve.from_affine_host(sum(rows, []), device=dev))
        dig = digits(sum(scs, [])).reshape(m, k, 2 * n, -1)
        picks = [j % k for j in range(m)]
        with sync_free():
            stacked = curve.msm_stacked_device(pv, dig)
            per_row = curve.msm_rows_device(
                pv, torch.stack([dig[j, b] for j, b in enumerate(picks)]),
                picks)
        want = [fh.g1_msm(rows[b], scs[j][b]) for j in range(m)
                for b in range(k)]
        check(curve.to_affine_host(stacked) == want,
              f"msm_stacked_device k={k}, n={n}, m={m}")
        check(curve.to_affine_host(per_row) == [want[j * k + b] for j, b in
                                                enumerate(picks)],
              f"msm_rows_device k={k}, n={n}, rows {picks}")
        print(f"msm_stacked_device [{m}, {k}] over [{k}, {n}] bases ({m * k} "
              f"rows of {2 * n} GLV lanes in one msm_select_reduce) and "
              f"msm_rows_device rows {picks}: every pair equals fh.g1_msm")


def check_folds(dev: torch.device, crs124, crs508, other512) -> None:
    """DeviceVec folded down to one point from the ELL=508 CRS's Gs + Hs
    (512 bases, 9 rounds) and the ELL=124 CRS's (128, 7 rounds), each
    round under sync-debug "error"; after each, DeviceVec.msm of fresh
    scalars equals FoldedBases.msm_many over the same gammas and, at N=128
    every round and at N=512 in round 1, the host's physical fold, lane
    for lane. Then StackedVec.fold at [2, 512] with a gamma per row."""
    from go_curdleproofs_tpu_torch.ops import curve, kernels
    from go_curdleproofs_tpu_torch.utils import field_host as fh
    from go_curdleproofs_tpu_torch.utils.rand import Rand

    def host_fold(pts, g):
        h = len(pts) // 2
        return [fh.g1_add(pts[i], fh.g1_mul(pts[i + h], g)) for i in range(h)]

    rand = Rand(FOLD_SEED)
    for what, bases, host_rounds in (
            (f"ELL={ELL_BIG} CRS Gs + Hs", crs508.gs + crs508.hs, 1),
            ("ELL=124 CRS Gs + Hs", crs124.gs + crs124.hs, 7)):
        dv = curve.DeviceVec.from_affine(bases, device=dev)
        lazy = curve.FoldedBases.from_affine([bases], device=dev)
        host, rounds, t0 = list(bases), 0, time.perf_counter()
        while dv.n_valid > 1:
            g = rand.get_fr()
            before = dict(kernels.launches)
            with sync_free():
                dv = dv.fold(g)
            if rounds == 0:
                one = _launched_since(before)
                check(one == FOLD_ROUND_LAUNCHES,
                      f"launches of one fold round: {one}")
            lazy = lazy.fold(g)
            rounds += 1
            sc = rand.get_frs(dv.n_valid)
            got = dv.msm(sc)
            check(got == lazy.msm_many([[(0, sc, 0)]])[0],
                  f"{what}: round {rounds}, DeviceVec.msm against the lazy "
                  f"fold")
            if rounds <= host_rounds:
                host = host_fold(host, g)
                check(curve.to_affine_host(dv.pv) == host
                      + [None] * (dv.width - len(host))
                      and got == fh.g1_msm(host, sc),
                      f"{what}: round {rounds} against the host's fold")
        check(rounds == dv.width.bit_length() - 1 and dv.to_affine()
              == lazy.msm_many([[(0, [1], 0)]]), f"{what}: the last point")
        print(f"DeviceVec from the {what} ({dv.width} bases) folded {rounds} "
              f"rounds to one point ({time.perf_counter() - t0:.1f} s): each "
              f"round's msm equals FoldedBases.msm_many, the host's fold "
              f"lane for lane in {host_rounds} round(s); one round launches "
              f"{FOLD_ROUND_LAUNCHES}")

    rows = [crs508.gs + crs508.hs, other512]
    n, h = len(other512), len(other512) // 2
    gammas = [rand.get_fr(), rand.get_fr()]
    sv = curve.StackedVec.from_affine(rows, device=dev)
    sv.table()
    with sync_free():
        f = sv.fold(gammas)
    want = [host_fold(r, g) for r, g in zip(rows, gammas)]
    check((f.k, f.width, f.n_valid) == (2, n, h) and f._table is None,
          f"StackedVec.fold [2, {n}]: shape, and a table of its own")
    check(curve.to_affine_host(f.pv) == sum((w + [None] * h for w in want),
                                            []),
          f"StackedVec.fold [2, {n}] against the host's fold, lane for lane")
    sc = rand.get_frs(h)
    check(f.msm_many([[(0, sc, 0)], [(1, sc, 0)]])
          == [fh.g1_msm(w, sc) for w in want],
          "the folded StackedVec's MSMs off its new table")
    print(f"StackedVec.fold [2, {n}] with a gamma per row: the host's fold "
          f"lane for lane; its new table's MSMs equal fh.g1_msm")


def check_sstate(dev: torch.device):
    """SState on the card against the host Strobe128, Merlin and Transcript:
    40 random meta-AD / AD / PRF operations of 1, 48, 52, 120 and 200
    bytes, the Merlin test vector, 9 chained challenges (the last three
    under labels of 33, 127 and 300 bytes, each one launch); the
    operations run under sync-debug "error", and every input state is
    unchanged after its call."""
    from go_curdleproofs_tpu_torch.ops import kernels
    from go_curdleproofs_tpu_torch.ops import strobe_dev as sd
    from go_curdleproofs_tpu_torch.utils.merlin import MerlinTranscript
    from go_curdleproofs_tpu_torch.utils.transcript import Transcript

    rng = random.Random(40)
    th = Transcript(b"chip_smoke")
    ops = []
    for _ in range(40):
        n = rng.choice([1, 48, 52, 120, 200])
        ops.append((rng.choice(["meta", "ad", "prf"]),
                    bytes(rng.randrange(256) for _ in range(n))))
    s = sd.from_host(th.inner.strobe, device=dev)
    runs = []                     # (input state, its copy, output state, out)
    one = []                      # each challenge's launches
    with sync_free():
        for kind, data in ops:
            copy = s.st.clone()
            if kind == "meta":
                s2, out = sd.meta_ad(s, data, False), None
            elif kind == "ad":
                s2, out = sd.ad(s, sd.bytes_tensor(data, dev), False), None
            else:
                s2, out = sd.prf(s, len(data))
            runs.append((s, copy, s2, out))
            s = s2
        for label in CHALLENGE_LABELS:
            copy = s.st.clone()
            before = dict(kernels.launches)
            s2, out = sd.get_and_append_challenge(s, label)
            one.append(_launched_since(before))
            runs.append((s, copy, s2, out))
            s = s2
    check(all(d == {"strobe_challenge32": 1} for d in one),
          f"SState: each challenge one strobe_challenge32 launch, saw {one}")
    h = th.inner.strobe
    for i, (s_in, copy, s_out, out) in enumerate(runs):
        if i < len(ops):
            kind, data = ops[i]
            if kind == "meta":
                h.meta_ad(data, False)
            elif kind == "ad":
                h.ad(data, False)
            else:
                check(bytes(out.tolist()) == h.prf(len(data), False),
                      f"SState prf of {len(data)} bytes, op {i}")
        else:
            label = CHALLENGE_LABELS[i - len(ops)]
            check(int.from_bytes(bytes(out.tolist()), "big")
                  == th.get_and_append_challenge(label),
                  f"SState challenge {i - len(ops)}, label of {len(label)} "
                  f"bytes")
        check(torch.equal(s_in.st, copy), f"SState op {i} left its input")
        check(bytes(s_out.st.tolist()) == bytes(h.state)
              and (s_out.pos, s_out.pos_begin) == (h.pos, h.pos_begin),
              f"SState op {i} against the host STROBE")
    mh = MerlinTranscript(b"test protocol")
    ms = sd.from_host(mh.strobe, device=dev)
    mh.append_message(b"some label", b"some data")
    ms = sd.append_message(ms, b"some label", b"some data")
    ms, out = sd.challenge_bytes(ms, b"challenge", 32)
    check(bytes(out.tolist()) == mh.challenge_bytes(b"challenge", 32)
          == bytes.fromhex(MERLIN_VECTOR), "SState: the Merlin test vector")
    print("SState: 40 operations of 1-200 bytes across the rate and 9 chained "
          "challenges (6 under a 1-byte label, 3 under labels of 33, 127 and "
          "300 bytes: one strobe_challenge32 launch each) as the host STROBE "
          "and transcript, no synchronising call, every input state "
          "unchanged; the Merlin test vector")


def phase_fold_msm_strobe(dev: torch.device, card: str, crs124) -> tuple:
    """Phase 8. Returns (launch counts of the fold rounds, device MSMs and
    SState runs; {ell: launch counts of its prove, verify and device
    prove} at ELL=252 and 508)."""
    from go_curdleproofs_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    ell_counts = {}
    _, _, ell_counts[ELL_MID] = phase_ell(dev, card, ELL_MID)
    crs508, other512, ell_counts[ELL_BIG] = phase_ell(dev, card, ELL_BIG)
    kernels.reset_launches()
    with CallInputs([(kernels, n) for n in FOLD_KERNELS]) as record:
        check_msm_entry_points(dev)
        check_folds(dev, crs124, crs508, other512)
        check_sstate(dev)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    for name in FOLD_KERNELS:
        check(counts[name] > 0, f"{name} launched by phase 8")
    shapes = check_recorded_kernels(record.calls, FOLD_KERNELS,
                                    "phase 8 (folds, device MSMs, SState)")
    print(f"phase 8: launches {counts}; recorded shapes {shapes}; "
          f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return counts, ell_counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from go_curdleproofs_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    card = phase_env(dev)
    phase_build()
    timings = phase_decode(dev)
    timings.update(phase_kernels(dev))
    timings.update(phase_kernels_device_prover(dev))
    verify_counts, crs, insts, gv = phase_verifier(dev, card)
    prove_counts, post, proof, host_ms = phase_prover(dev, card, crs, insts,
                                                      gv)
    device_counts = phase_device_prover(dev, card, crs, insts, gv, post,
                                        proof, host_ms)
    fold_counts, ell_counts = phase_fold_msm_strobe(dev, card, crs)
    batch_counts = phase_batch_verify(dev, card, crs, insts)
    check("jax" not in sys.modules
          and "go_curdleproofs_tpu" not in sys.modules,
          "neither jax nor the JAX package imported")
    torch.cuda.synchronize()
    print(card)
    summary = [dict(name=name, route="cuda",
                    source=CSRC + kernels.KERNEL_SOURCE[name],
                    replaces=REPLACES[name],
                    launches=verify_counts[name] + prove_counts[name]
                    + device_counts[name] + batch_counts[name]
                    + fold_counts[name] + ell_counts[ELL_MID][name]
                    + ell_counts[ELL_BIG][name],
                    launches_two_verifies=verify_counts[name],
                    launches_one_prove=prove_counts[name],
                    launches_one_device_prove=device_counts[name],
                    launches_batch_verifies_b2_b8_b32=batch_counts[name],
                    launches_fold_msm_strobe=fold_counts[name],
                    launches_ell252_prove_verify_device_prove=ell_counts[
                        ELL_MID][name],
                    launches_ell508_prove_verify_device_prove=ell_counts[
                        ELL_BIG][name],
                    library_ms=None, **timings[name]) for name in REPLACES]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
