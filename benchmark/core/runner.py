"""One run of one cell: set-up, warm-up, the measured window, the output
check against the reference, and the result line.

The driver of the cell's mix supplies the requests; this module times
them. With trace on, the window's requests run under the section clock,
and `trace_requests` more after the window under torch.profiler too; the
metrics are then the cell's per-layer ones, and else its end-to-end ones.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from . import spec, trace
from .check import Check, default_workers


@dataclass
class Request:
    """One request of a mix: `run` returns its answer, which the driver's
    check judges; `items` counts the proofs it verifies or makes; `work`
    is its least device work (roofline.work_macs_bytes)."""
    run: Callable[[], object]
    items: int = 1
    work: Dict = field(default_factory=dict)
    meta: Dict = field(default_factory=dict)


@dataclass
class Done:
    index: int
    t0: float
    t1: float
    answer: object
    error: Optional[str]
    items: int
    work: Dict
    meta: Dict
    sections: Dict[str, float]
    profiled: bool = False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Context:
    config: Dict
    traffic: Dict
    seed: int
    device: torch.device
    workers: int


@dataclass
class RunData:
    """What the metric readers read."""
    done: List[Done]
    window_s: float
    setup_s: float
    traced: bool
    profile: Optional[Dict] = None


def _sync(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def prepare(cell: spec.Cell, seed: int, *, device: torch.device,
            workers: Optional[int] = None):
    """The cell's driver after its set-up and warm-up; the seconds of each
    go to standard error."""
    ctx = Context(cell.config, cell.traffic, seed, device,
                  workers or default_workers())
    drv = cell.driver.Driver(ctx)
    t0 = time.perf_counter()
    drv.setup()
    t1 = time.perf_counter()
    drv.warm()
    _sync(device)()
    t2 = time.perf_counter()
    print(f"set-up: driver {t1 - t0:.3f} s, warm-up {t2 - t1:.3f} s",
          file=sys.stderr)
    return drv


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
             device: torch.device, t_process: float,
             workers: Optional[int] = None):
    drv = prepare(cell, seed, device=device, workers=workers)
    return measure(cell, drv, seconds, traced, device=device,
                   setup_s=time.time() - t_process)


def measure(cell: spec.Cell, drv, seconds: float, traced: bool, *,
            device: torch.device, setup_s: float):
    """The window, the check and the result line: (result, checks)."""
    sync = _sync(device)
    clock = (trace.SectionClock(spec.sections(cell.bench_dir), sync)
             if traced else contextlib.nullcontext())
    done: List[Done] = []

    def one(i: int, profiled: bool = False) -> None:
        req = drv.request(i)
        if traced:
            clock.new_request()
        marker = (torch.profiler.record_function(trace.REQUEST) if traced
                  else contextlib.nullcontext())
        t0 = time.perf_counter()
        error = None
        with marker:
            try:
                answer = req.run()
            except Exception as e:              # a request that never came
                answer, error = None, repr(e)
        t1 = time.perf_counter()
        done.append(Done(i, t0, t1, answer, error, req.items, req.work,
                         req.meta, dict(clock.ms) if traced else {},
                         profiled))

    t_start = time.perf_counter()
    deadline = t_start + seconds
    profile = None
    with clock:
        while time.perf_counter() < deadline:
            one(len(done))
        window_s = (done[-1].t1 - t_start) if done else seconds
        # the profiled requests follow the window: the profiler's own
        # costs stay out of it, and its trace holds only their kernels
        to_profile = int(cell.traffic.get("trace_requests", 0)) \
            if traced else 0
        if to_profile:
            with _profiler(device) as prof:
                for _ in range(to_profile):
                    one(len(done), profiled=True)
            profile = trace.read_profile(prof, to_profile)
    sync()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks: List[Check] = [Check("failed_requests",
                                 sum(d.error is not None for d in done), 0)]
    t_check = time.perf_counter()
    checks += drv.check(done)
    print(f"check: the reference's comparison took "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    data = RunData(done, window_s, setup_s, traced, profile)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric_reader(cell.bench_dir, m["name"]).read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": memory_peak}
    if traced and profile:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
    result = {"correct": all(c.ok for c in checks),
              "attempted": len(done),
              "failed": sum(d.error is not None for d in done),
              "metrics": metrics, "device": dev}
    if traced and profile:
        result["breakdown"] = profile["breakdown"]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                                 "at_most": c.at_most} for c in checks}
    return result, checks
