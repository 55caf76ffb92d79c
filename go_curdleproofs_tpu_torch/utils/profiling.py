"""The port's tracer: spans at its layer boundaries, with request ids, on
a clock that torch.profiler's trace can be laid over.

  * span(name): a context manager, and traced(name) the same around a
    whole function, as a decorator. While spans record, each one keeps a
    record (`Span`): its name, its id, the id of the span open around it
    (0 for none), its request id, and its start and end from
    time.perf_counter_ns(). A span opened with no span open is a root and
    starts a new request id; every span inside it shares that id. A span
    reads the host's clock only: it never synchronises the card and never
    opens a torch.profiler range, so it adds no event to a profiler's
    trace. A wait for the card shows only where the program itself blocks
    (the `fetch` spans around blocking device-to-host copies).
  * count(name, n): adds n to a counter of the innermost open span's
    record, so counts sit at the same boundaries as the spans. Call sites
    whose count costs work to reckon ask `recording()` first.
  * Spans record while torch.profiler records (read from a module global
    of torch at each span), and after enable() until disable().
    CURDLE_PROFILE=1 in the environment at import calls enable(); nothing
    reads the environment after that. Otherwise a span is one check and
    no record.
  * Records stay in memory, in a log of at most LIMIT records; beyond it
    new ones are counted in `dropped()` and not kept. records() hands out
    the log, drain() hands it out and empties it, reset() empties it.
    report() is a table of self time (a span's time less its children's)
    by name over the log; totals() sums wall time and calls by name.
  * The clock: each root keeps time.time_ns() - time.perf_counter_ns(),
    read back to back as it opens (its `offset`), and its spans share it;
    that puts a record's times on the Unix epoch, the clock of
    torch.profiler's absolute times (its trace's trace_start_ns() plus an
    event's time_range, in us). `profiler_us(rec, t, trace_start_ns)` gives
    a record's time on that trace's own axis.

Names are static strings; sizes go into counters. Spans are kept for one
thread: the port opens none on another.
"""

from __future__ import annotations

import functools
import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

_ap = torch.autograd.profiler

LIMIT = 1 << 20

_on = False
_log: List["Span"] = []
_dropped = 0
_stack: List["Span"] = []
_next_id = 1
_next_request = 1


def recording() -> bool:
    """Do spans record now?"""
    return _on or _ap._is_profiler_enabled


class Span:
    """One span's record, and the context manager that makes it."""
    __slots__ = ("name", "id", "parent", "request", "start", "end",
                 "counts", "offset")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "Span":
        global _next_id, _next_request, _dropped
        self.id = _next_id
        _next_id += 1
        if _stack:
            top = _stack[-1]
            self.parent, self.request = top.id, top.request
            self.offset = top.offset
        else:
            self.parent, self.request = 0, _next_request
            _next_request += 1
            p = time.perf_counter_ns()
            self.offset = time.time_ns() - p
        self.counts = None
        self.end = 0
        _stack.append(self)
        if len(_log) < LIMIT:
            _log.append(self)
        else:
            _dropped += 1
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        _stack.pop()
        return False

    @property
    def ns(self) -> int:
        return self.end - self.start


class _Off:
    """The span of a run that records nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str):
    """A span named `name` (a static string) around a with-block."""
    return Span(name) if recording() else _OFF


def traced(name: str):
    """A decorator: a span named `name` around each call of the function."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not recording():
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int) -> None:
    """Add n to the counter `name` of the innermost open span."""
    if _stack:
        top = _stack[-1]
        if top.counts is None:
            top.counts = {name: n}
        else:
            top.counts[name] = top.counts.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def records() -> List[Span]:
    """The log, oldest first (a copy of the list; the records are the
    log's own)."""
    return list(_log)


def drain() -> List[Span]:
    """The log, oldest first; the log is empty after it."""
    out = list(_log)
    _log.clear()
    return out


def dropped() -> int:
    """Records not kept since the last reset, the log being full."""
    return _dropped


def reset() -> None:
    global _dropped
    _log.clear()
    _dropped = 0


def profiler_us(rec: Span, t: int, trace_start_ns: int) -> float:
    """Time t of record rec on the axis of a torch.profiler trace whose
    trace_start_ns() is `trace_start_ns`: the axis of its events'
    time_range, in us."""
    return (t + rec.offset - trace_start_ns) / 1e3


def self_ns(recs: List[Span]) -> Dict[int, int]:
    """{span id: its time less its children's} over `recs`."""
    out = {r.id: r.ns for r in recs}
    for r in recs:
        if r.parent in out:
            out[r.parent] -= r.ns
    return out


def totals() -> Dict[str, Tuple[float, int]]:
    """{name: (total seconds, calls)} over the log."""
    out: Dict[str, List] = defaultdict(lambda: [0, 0])
    for r in _log:
        s = out[r.name]
        s[0] += r.ns
        s[1] += 1
    return {name: (ns / 1e9, calls) for name, (ns, calls) in out.items()}


def report() -> str:
    """Self time, total time and calls by name over the log, the largest
    self time first."""
    own = self_ns(_log)
    rows: Dict[str, List] = defaultdict(lambda: [0, 0, 0])
    for r in _log:
        row = rows[r.name]
        row[0] += 1
        row[1] += own[r.id]
        row[2] += r.ns
    lines = [f"{'span':<40} {'calls':>6} {'self_ms':>10} {'total_ms':>10}"]
    for name, (calls, own_ns, ns) in sorted(rows.items(),
                                            key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<40} {calls:>6} {own_ns / 1e6:>10.3f} "
                     f"{ns / 1e6:>10.3f}")
    if _dropped:
        lines.append(f"({_dropped} records dropped: the log holds {LIMIT})")
    return "\n".join(lines)


if os.environ.get("CURDLE_PROFILE", "0") == "1":
    enable()
