"""Where the time goes in an ELL=124 verify, prove and device prove on the
card.

    python3 -m go_curdleproofs_tpu_torch.profile_port [OUT.json]

Needs one CUDA card (it fails without one) and the repository's
tests/fixture_whisk_ell124.json. For the verifier and for the
host-orchestrated prover it prints, and writes to OUT.json when that is
given:

  * wall time of REPS warm runs (each ends in a synchronise), median and
    range;
  * the split by section, from host clocks around the section's function
    with a synchronise at its end: batched decode, batched scalar
    multiplication, MSM calls (with the host digit recoding and the fetch
    inside them counted apart), and the rest, which is host work:
    transcript, Fr arithmetic, single-point group operations;
  * from torch.profiler over the same number of runs: CUDA kernel launches
    per run, device time per run and the device-busy share of the wall time,
    and the device time of the top 8 kernels and of each of the port's own.

The section clocks add a synchronise per section, so the sections are timed
in their own runs, apart from the wall-time runs.

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
from .utils.rand import Rand

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixture_whisk_ell124.json"
REPS = 5

# (owner, attribute, section name); nested sections are reported apart
SECTIONS = [
    (codec_batch, "batch_decompress", "decode"),
    (curve, "batch_scalar_mul", "batch_scalar_mul"),
    (curve, "msm_with_static", "final_msm"),
    (curve.StackedVec, "msm_many", "msm_many"),
    (curve, "scalars_to_digits", "inside: host digit recoding"),
    (curve, "to_affine_host", "inside: fetch + host normalisation"),
    (curve, "to_affine_host_xy", "inside: compress_xy + fetch"),
    (curve, "build_table", "inside: table build"),
]


class SectionClock:
    """Wraps the section functions with synchronised host clocks."""

    def __init__(self):
        self.ms = defaultdict(float)
        self.calls = defaultdict(int)
        self._saved = []

    def __enter__(self):
        for owner, attr, name in SECTIONS:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)

    def _wrap(self, fn, name):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[name] += (time.perf_counter() - t0) * 1e3
            self.calls[name] += 1
            return out
        return timed


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
    synchronise so that the chain starts on an idle card)."""

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
        return self

    def __exit__(self, *exc):
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


def profile_device_prove(name: str, fn) -> dict:
    fn()                                                  # warm
    walls = [_wall_ms(fn) for _ in range(REPS)]
    with PieceClock() as clock:
        piece_walls = [_wall_ms(fn) for _ in range(REPS)]
        pieces = {k: v / REPS for k, v in clock.piece_ms().items()}
    kernels.reset_launches()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_walls = [_wall_ms(fn) for _ in range(REPS)]
    launches = {k: v / REPS for k, v in kernels.launches.items()}
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
        top_device_kernels=[dict(name=e.key[:80], count=e.count / REPS,
                                 device_ms_per_run=e.self_device_time_total
                                 / 1e3 / REPS) for e in top])
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


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile(name: str, fn) -> dict:
    fn()                                                  # warm
    walls = [_wall_ms(fn) for _ in range(REPS)]
    with SectionClock() as clock:
        sect_walls = [_wall_ms(fn) for _ in range(REPS)]
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
    sections = {k: dict(ms_per_run=v / REPS, calls_per_run=clock.calls[k]
                        / REPS) for k, v in clock.ms.items()}
    outer = sum(v["ms_per_run"] for k, v in sections.items()
                if not k.startswith("inside"))
    res = dict(
        wall_ms_median=statistics.median(walls), wall_ms_min=min(walls),
        wall_ms_max=max(walls),
        sectioned_wall_ms_median=statistics.median(sect_walls),
        sections=sections,
        host_rest_ms_per_run=statistics.mean(sect_walls) - outer,
        cuda_kernel_launches_per_run=n_kernels / REPS,
        device_ms_per_run=device_ms / REPS,
        device_busy_share=device_ms / sum(prof_walls),
        profiled_wall_ms_median=statistics.median(prof_walls),
        port_kernel_launches_per_run=launches,
        top_device_kernels=[dict(name=e.key[:80], count=e.count / REPS,
                                 device_ms_per_run=e.self_device_time_total
                                 / 1e3 / REPS) for e in top])
    print(f"== {name}")
    print(json.dumps(res, indent=1))
    return res


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
               verify=profile("verify ELL=124", verify),
               prove=profile("prove ELL=124", prove),
               device_prove=profile_device_prove(
                   "device prove ELL=124 (prover=device)", device_prove))
    if len(sys.argv) > 1:
        out = Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
