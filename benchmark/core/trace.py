"""What a traced run records: host-clock sections around calls into the
program's layers, and the card's kernels from torch.profiler.

Sections are patched in for the traced run only. Each wraps a call into a
layer with a synchronise on both sides and keeps its self time (its time
less that of sections called inside it), per request; a section that saw
no call in a request has no entry there. Each call is also marked for the
profiler (`bench.section:<name>`), as is each request (`bench.request`),
so that the device's idle gaps can be named by what the host was doing;
the profiler also shows these marks on the device's timeline, where they
are not operations and are left out.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

REQUEST = "bench.request"
SECTION = "bench.section:"


def _resolve(target: str) -> Tuple[object, str]:
    """'pkg.module:Class.attr' -> (owner object, attribute name)."""
    mod_name, path = target.split(":")
    owner = importlib.import_module(mod_name)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


class SectionClock:
    """Patches every target of `sections` while entered; `ms` holds the
    current request's self time per section called."""

    def __init__(self, sections: Dict[str, List[str]],
                 sync: Callable[[], None]):
        self.sections = sections
        self.sync = sync
        self.ms: Dict[str, float] = defaultdict(float)
        self._stack: List[List[float]] = []
        self._saved = []

    def new_request(self) -> None:
        self.ms = defaultdict(float)

    def __enter__(self):
        for name, targets in self.sections.items():
            for target in targets:
                owner, attr = _resolve(target)
                fn = owner.__dict__[attr] if isinstance(owner, type) \
                    else getattr(owner, attr)
                self._saved.append((owner, attr, fn))
                setattr(owner, attr, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []

    def _wrap(self, fn, name: str):
        if isinstance(fn, (staticmethod, classmethod)):
            raise TypeError(f"section {name}: wrap the function, not {fn!r}")

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            self.sync()
            frame = [time.perf_counter(), 0.0]      # start, time of children
            self._stack.append(frame)
            try:
                with torch.profiler.record_function(SECTION + name):
                    out = fn(*args, **kwargs)
                    self.sync()
            finally:
                self._stack.pop()
            spent = time.perf_counter() - frame[0]
            self.ms[name] += (spent - frame[1]) * 1e3
            if self._stack:
                self._stack[-1][1] += spent
            return out
        return timed


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def short_name(name: str) -> str:
    head = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return head.split("(")[0].split("<")[0].strip()[:64] or name[:64]


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_profile(prof, requests: int) -> Optional[Dict]:
    """Kernel counts, device time, busy and window seconds and the
    breakdown of the profiled requests; None when the trace holds no
    device activity."""
    device, markers = [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("bench."):
            if e.device_type == torch.autograd.DeviceType.CPU:
                markers.append((tr.start, tr.end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((tr.start, tr.end, e.name))
    reqs = [m for m in markers if m[2] == REQUEST]
    if not device or not reqs:
        return None
    w0 = min(m[0] for m in reqs)
    w1 = max(m[1] for m in reqs)
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    if not device:
        return None
    busy = _merge([(max(s, w0), min(e, w1)) for s, e, _ in device])
    busy_us = sum(e - s for s, e in busy)
    by_op: Dict[str, float] = defaultdict(float)
    for s, e, name in device:
        by_op[short_name(name)] += (e - s) * 1e-6
    # idle gaps, each piece named by the innermost section open on the host
    # over it (else host_rest inside a request, harness between requests)
    # and by the device operation before the gap
    sections = [m for m in markers if m[2] != REQUEST]
    ends = sorted((e, short_name(n)) for _, e, n in device)
    end_times = [e for e, _ in ends]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        k = bisect.bisect_right(end_times, g0)
        after = f" after {ends[k - 1][1]}" if k else ""
        inside = [m for m in sections if m[0] < g1 and m[1] > g0]
        cuts = sorted({g0, g1} | {x for m in inside for x in m[:2]
                                  if g0 < x < g1})
        for x0, x1 in zip(cuts, cuts[1:]):
            mid = (x0 + x1) / 2
            inner = [m for m in inside if m[0] <= mid < m[1]]
            if inner:
                where = min(inner, key=lambda m: m[1] - m[0])[2][len(SECTION):]
            elif any(r[0] <= mid < r[1] for r in reqs):
                where = "host_rest"
            else:
                where = "harness"
            gaps[where + after] += (x1 - x0) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    kernel_s = sum((e - s) * 1e-6 for s, e, n in device)
    return dict(
        requests=requests,
        launches=sum(1 for *_, n in device if _is_kernel(n)),
        device_s=kernel_s,
        busy_s=busy_us * 1e-6,
        window_s=(w1 - w0) * 1e-6,
        breakdown=dict(device_ops=top(by_op), idle_gaps=top(gaps)))
