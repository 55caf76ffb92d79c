"""Where the time goes in an ELL=124 verify, prove and device prove on the
card.

    python3 -m go_curdleproofs_tpu_torch.profile_port [OUT.json]

Needs one CUDA card (it fails without one) and the repository's
tests/fixture_whisk_ell124.json. For the verifier and for the
host-orchestrated prover it prints, and writes to OUT.json when that is
given:

  * wall time of REPS warm runs (each ends in a synchronise), median and
    range;
  * the split by the program's own spans (utils/profiling.py), from runs
    with the spans on: self time and calls a run of each span name (the
    root, the transcript, each sub-argument, decode and its parts, the
    MSMs and their recoding, uploads, fetches and conversions), and the
    counters (points decoded, lanes, MSM terms and lanes) a run;
  * from torch.profiler over the same number of runs: CUDA kernel launches
    per run, device time per run and the device-busy share of the wall time,
    and the device time of the top 8 kernels and of each of the port's own,
    per run and a launch;
  * the elements of each mont_mul launch (B1) in one more run, as a
    histogram {elements: launches a run}, which is where B1's team size was
    chosen; for the device prover the same of fr_mont_mul.

Before the paths it measures the launch floor: the time a launch of a
one-element torch fill (zero_() on one int32) takes on the card, read by
the same profiler, which is the least a launch of any kernel takes there.

The spans are timed in their own runs, apart from the wall-time runs; they
synchronise nothing, so a span around device work times its enqueue, and
the `fetch` spans the waits for the card.

Then batched verification (parallel/batch.py) of 8 and 32 distinct ELL=124
proofs on a one-rank NCCL group, with the same spans and counts.

For the device-resident prover (prover="device") the sections are its
pieces, timed with CUDA events recorded in the stream (no synchronise, so
the chain stays one chain): the span of each piece on the device, which
includes the time the card waits for the host to enqueue. Beside them, on
the host clock: the upload, the enqueue of the whole chain (the host's
share) and the one fetch (the wait for the card to drain, then the copy);
and the same launch count, device time and device-busy share as above.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

from .models import (curdleproof, device_prover2, device_prover_full,
                     whisk)
from .ops import codec_batch, curve, kernels
from .parallel import batch as pbatch
from .parallel import msm as pmsm
from .utils import profiling
from .utils.rand import Rand

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixture_whisk_ell124.json"
REPS = 5

# the device prover's pieces: (owner, attribute)
PIECES = [
    (device_prover_full, "_piece_sameperm"),
    (device_prover_full, "_piece_gpa1"),
    (device_prover_full, "_piece_gpa2"),
    (device_prover_full, "_piece_blind1"),
    (device_prover_full, "_piece_blind2"),
    (device_prover_full, "_piece_blind3"),
    (device_prover2, "_ipa_setup"),
    (device_prover2, "run_ipa_rounds"),
    (device_prover_full, "_piece_sigma"),
    (device_prover2, "_sm_setup"),
    (device_prover2, "run_sm_rounds"),
    (device_prover_full, "_piece_finalize"),
]
HOST_STAGES = [(device_prover_full, "_upload", True),
               (device_prover_full, "_chain", False),
               (device_prover_full, "fetch", False)]


class PieceClock:
    """Wraps the device prover's pieces with CUDA events in the stream, and
    its three host stages with host clocks (the upload ends in a
    synchronise so that the chain starts on an idle card). The chain runs
    eagerly while the clock is on: a replay of its CUDA graph has no
    pieces."""

    def __init__(self):
        self.events = []
        self.host_ms = defaultdict(float)
        self._saved = []

    def __enter__(self):
        for owner, attr in PIECES:
            self._patch(owner, attr, self._wrap_piece(getattr(owner, attr),
                                                      attr))
        for owner, attr, sync_after in HOST_STAGES:
            self._patch(owner, attr, self._wrap_host(getattr(owner, attr),
                                                     attr, sync_after))
        self._eager = device_prover_full.eager_chain()
        self._eager.__enter__()
        return self

    def __exit__(self, *exc):
        self._eager.__exit__(*exc)
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)

    def _patch(self, owner, attr, fn):
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def _wrap_piece(self, fn, name):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((name, start, end))
            return out
        return timed

    def _wrap_host(self, fn, name, sync_after):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync_after:
                torch.cuda.synchronize()
            self.host_ms[name] += (time.perf_counter() - t0) * 1e3
            return out
        return timed

    def piece_ms(self):
        """Device span per piece, summed over the recorded runs."""
        torch.cuda.synchronize()
        out = defaultdict(float)
        for name, start, end in self.events:
            out[name] += start.elapsed_time(end)
        return out


class MulShapes:
    """Counts the elements of every launch of a multiply wrapper
    (`mont_mul` or `fr_mont_mul`, by its output) while it is entered."""

    def __init__(self, name: str):
        self.name = name
        self.hist = defaultdict(int)

    def __enter__(self):
        self._saved = getattr(kernels, self.name)

        def counted(a, b):
            out = self._saved(a, b)
            self.hist[out.numel() // out.shape[-1]] += 1
            return out
        setattr(kernels, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(kernels, self.name, self._saved)


def mul_histogram(fn, name: str = "mont_mul") -> dict:
    """{elements: launches} of the multiply `name` over one run of fn, the
    device prover's chain run eagerly (a replay of its CUDA graph calls no
    wrapper)."""
    with device_prover_full.eager_chain(), MulShapes(name) as shapes:
        fn()
    return {str(k): v for k, v in sorted(shapes.hist.items())}


def launch_floor(launches: int = 50) -> dict:
    """The card's time a launch of a one-element torch fill (zero_() on
    one int32), from torch.profiler over `launches` launches."""
    t = torch.zeros(1, dtype=torch.int32, device="cuda")
    t.zero_()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            t.zero_()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    count = sum(e.count for e in ev)
    us = sum(e.self_device_time_total for e in ev) / max(count, 1)
    res = dict(kernels=[e.key[:80] for e in ev], launches=count,
               device_us_a_launch=us)
    print(f"== launch floor: one-element zero_(), {count} launches, "
          f"{us:.3f} us a launch on the card")
    return res


def profile_device_prove(name: str, fn) -> dict:
    fn()                                                  # warm
    walls = [_wall_ms(fn) for _ in range(REPS)]
    with PieceClock() as clock:
        piece_walls = [_wall_ms(fn) for _ in range(REPS)]
        pieces = {k: v / REPS for k, v in clock.piece_ms().items()}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_walls = [_wall_ms(fn) for _ in range(REPS)]
    launches = {k: v / REPS for k, v in
                kernels.traced_launches(prof.key_averages()).items()}
    cuda_events = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in cuda_events) / 1e3
    top = _top_kernels(cuda_events)
    res = dict(
        wall_ms_median=statistics.median(walls), wall_ms_min=min(walls),
        wall_ms_max=max(walls),
        pieces_wall_ms_median=statistics.median(piece_walls),
        piece_device_span_ms_per_run=pieces,
        host_upload_ms_per_run=clock.host_ms["_upload"] / REPS,
        host_chain_enqueue_ms_per_run=clock.host_ms["_chain"] / REPS,
        fetch_ms_per_run=clock.host_ms["fetch"] / REPS,
        cuda_kernel_launches_per_run=sum(e.count for e in cuda_events) / REPS,
        device_ms_per_run=device_ms / REPS,
        device_busy_share=device_ms / sum(prof_walls),
        profiled_wall_ms_median=statistics.median(prof_walls),
        port_kernel_launches_per_run=launches,
        top_device_kernels=_kernel_rows(top),
        mont_mul_elements_per_launch=mul_histogram(fn),
        fr_mont_mul_elements_per_launch=mul_histogram(fn, "fr_mont_mul"))
    print(f"== {name}")
    print(json.dumps(res, indent=1))
    return res


def _top_kernels(cuda_events):
    """The 8 kernels with the most device time, and each of the port's own
    kernels beside them."""
    ranked = sorted(cuda_events, key=lambda e: -e.self_device_time_total)
    own = tuple(f"{name}_kernel" for name in kernels.KERNEL_NAMES)
    return [e for i, e in enumerate(ranked)
            if i < 8 or any(k in e.key for k in own)]


def _kernel_rows(events):
    return [dict(name=e.key[:80], count=e.count / REPS,
                 device_ms_per_run=e.self_device_time_total / 1e3 / REPS,
                 device_ms_a_launch=e.self_device_time_total / 1e3 / e.count)
            for e in events]


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def span_split(fn) -> tuple:
    """REPS runs of fn with the spans on: (their walls, {span name: self
    ms and calls a run}, {counter: its sum a run})."""
    profiling.reset()
    profiling.enable()
    try:
        walls = [_wall_ms(fn) for _ in range(REPS)]
    finally:
        profiling.disable()
    recs = profiling.drain()
    own = profiling.self_ns(recs)
    spans = defaultdict(lambda: dict(self_ms_per_run=0.0, calls_per_run=0.0))
    counts = defaultdict(float)
    for r in recs:
        spans[r.name]["self_ms_per_run"] += own[r.id] / 1e6 / REPS
        spans[r.name]["calls_per_run"] += 1 / REPS
        for k, v in (r.counts or {}).items():
            counts[k] += v / REPS
    return walls, dict(spans), dict(counts)


def profile(name: str, fn) -> dict:
    fn()                                                  # warm
    walls = [_wall_ms(fn) for _ in range(REPS)]
    span_walls, spans, counts = span_split(fn)
    kernels.reset_launches()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_walls = [_wall_ms(fn) for _ in range(REPS)]
    launches = {k: v / REPS for k, v in kernels.launches.items()}
    cuda_events = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    n_kernels = sum(e.count for e in cuda_events)
    device_ms = sum(e.self_device_time_total for e in cuda_events) / 1e3
    top = _top_kernels(cuda_events)
    res = dict(
        wall_ms_median=statistics.median(walls), wall_ms_min=min(walls),
        wall_ms_max=max(walls),
        spanned_wall_ms_median=statistics.median(span_walls),
        spans=dict(sorted(spans.items(),
                          key=lambda kv: -kv[1]["self_ms_per_run"])),
        counters_per_run=counts,
        cuda_kernel_launches_per_run=n_kernels / REPS,
        device_ms_per_run=device_ms / REPS,
        device_busy_share=device_ms / sum(prof_walls),
        profiled_wall_ms_median=statistics.median(prof_walls),
        port_kernel_launches_per_run=launches,
        top_device_kernels=_kernel_rows(top),
        mont_mul_elements_per_launch=mul_histogram(fn))
    print(f"== {name}")
    print(json.dumps(res, indent=1))
    return res


def chained_proofs(crs, pre, count: int, *, device: torch.device,
                   seed: int = 0xBA7C) -> list:
    """`count` distinct Whisk shuffle proofs from the host prover, each
    shuffling the previous one's post-trackers (as block after block does):
    [(pre, post, proof bytes)]; proof i from Rand(seed + i)."""
    out = []
    for i in range(count):
        post, proof = whisk.generate_whisk_shuffle_proof(
            crs, pre, Rand(seed + i), device=device)
        out.append((pre, post, proof))
        pre = post
    return out


def profile_batches(dev: torch.device, crs, pre) -> dict:
    """Batched verification of 8 and 32 distinct ELL=124 proofs
    (chained_proofs) on a one-rank NCCL group made from a FileStore."""
    import os
    import tempfile

    import torch.distributed as dist

    chain = chained_proofs(crs, pre, 32, device=dev)
    torch.cuda.set_device(dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        group = pmsm.init_file_group(os.path.join(tmp, "store"), rank=0,
                                     world_size=1, backend="nccl")
        try:
            for b in (8, 32):
                def verify(batch=chain[:b]):
                    if not pbatch.verify_shuffle_proofs_batch(
                            crs, batch, Rand(9), device=dev, group=group):
                        raise RuntimeError("batch rejected")
                out[f"batch_verify_b{b}"] = profile(
                    f"batch verify b{b} ELL=124 (one-rank NCCL group)",
                    verify)
        finally:
            dist.destroy_process_group()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    with open(FIXTURE) as f:
        fx = json.load(f)
    crs = curdleproof.generate_crs(fx["ell"], Rand(fx["crs_seed"]),
                                   device=dev)
    inst = fx["instances"][0]
    pre = [whisk.WhiskTracker(bytes.fromhex(a), bytes.fromhex(b))
           for a, b in inst["pre"]]
    post = [whisk.WhiskTracker(bytes.fromhex(a), bytes.fromhex(b))
            for a, b in inst["post"]]
    proof = bytes.fromhex(inst["proof"])

    def verify():
        if not whisk.is_valid_whisk_shuffle_proof(crs, pre, post, proof,
                                                  Rand(7), device=dev):
            raise RuntimeError("fixture proof rejected")

    def prove():
        whisk.generate_whisk_shuffle_proof(crs, pre, Rand(9), device=dev)

    def device_prove():
        whisk.generate_whisk_shuffle_proof(crs, pre, Rand(9), device=dev,
                                           prover="device")

    res = dict(card=card, ell=fx["ell"], reps=REPS,
               launch_floor=launch_floor(),
               verify=profile("verify ELL=124", verify),
               prove=profile("prove ELL=124", prove),
               device_prove=profile_device_prove(
                   "device prove ELL=124 (prover=device)", device_prove))
    res.update(profile_batches(dev, crs, pre))
    if len(sys.argv) > 1:
        out = Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
