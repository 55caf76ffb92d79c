"""Where the time goes in an ELL=124 verify and prove on the card.

    python3 -m go_curdleproofs_tpu_torch.profile_port [OUT.json]

Needs one CUDA card (it fails without one) and the repository's
tests/fixture_whisk_ell124.json. For the verifier and for the prover it
prints, and writes to OUT.json when that is given:

  * wall time of REPS warm runs (each ends in a synchronise), median and
    range;
  * the split by section, from host clocks around the section's function
    with a synchronise at its end: batched decode, batched scalar
    multiplication, MSM calls (with the host digit recoding and the fetch
    inside them counted apart), and the rest, which is host work:
    transcript, Fr arithmetic, single-point group operations;
  * from torch.profiler over the same number of runs: CUDA kernel launches
    per run, device time per run and the device-busy share of the wall time.

The section clocks add a synchronise per section, so the sections are timed
in their own runs, apart from the wall-time runs.
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

from .models import curdleproof, whisk
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
    top = sorted(cuda_events, key=lambda e: -e.self_device_time_total)[:8]
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

    res = dict(card=card, ell=fx["ell"], reps=REPS,
               verify=profile("verify ELL=124", verify),
               prove=profile("prove ELL=124", prove))
    if len(sys.argv) > 1:
        out = Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
