"""Span accounting and a torch.profiler trace: the port's counterpart of
go_curdleproofs_tpu/utils/profiling.py.

  * span(name): host wall-clock time and calls, summed per name, while
    CURDLE_PROFILE=1 is set (read at each span, so it can be turned on
    for one run); report() prints the table, reset() clears it. A span
    reads the host clock only and never synchronises the card: around
    device work it measures the enqueue, not the kernels;
  * torch_trace(): a torch.profiler trace of what runs inside it (CPU,
    and CUDA when a card is present), written as a Chrome trace into the
    directory named by CURDLE_TORCH_TRACE when that is set.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

_spans = defaultdict(lambda: [0.0, 0])


def enabled() -> bool:
    return os.environ.get("CURDLE_PROFILE", "0") == "1"


@contextlib.contextmanager
def span(name: str):
    if not enabled():
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s = _spans[name]
        s[0] += time.perf_counter() - t0
        s[1] += 1


def totals() -> dict:
    """{name: (total seconds, calls)} of the spans so far."""
    return {name: (total, calls) for name, (total, calls) in _spans.items()}


def report() -> str:
    lines = [f"{'span':<40} {'calls':>6} {'total_ms':>10} {'avg_ms':>9}"]
    for name, (total, calls) in sorted(_spans.items(),
                                       key=lambda kv: -kv[1][0]):
        lines.append(f"{name:<40} {calls:>6} {total * 1e3:>10.1f} "
                     f"{total / calls * 1e3:>9.2f}")
    return "\n".join(lines)


def reset() -> None:
    _spans.clear()


@contextlib.contextmanager
def torch_trace():
    trace_dir = os.environ.get("CURDLE_TORCH_TRACE")
    if not trace_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
