"""The program's own spans (go_curdleproofs_tpu_torch/utils/profiling.py),
for the per-layer metrics that read them.

The port records spans while torch.profiler records, so the requests that
a traced run profiles after its window hold them. Each profiled request
gets the records whose root span opened and closed inside its
[t0, t1] (both on time.perf_counter). Where the program keeps no records
(a version of it without them) or a profiled request holds no root, there
is nothing to read and each reader returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

SLACK_NS = 1000         # Done's float seconds against the spans' integer ns


def _records():
    try:
        from go_curdleproofs_tpu_torch.utils import profiling
        return list(profiling.records())
    except (ImportError, AttributeError):
        return None


def per_request(data) -> Optional[List[List]]:
    """For each profiled request that completed, its requests' records;
    None where there is nothing to read."""
    if not data.traced:
        return None
    done = [d for d in data.done if d.profiled and d.error is None]
    recs = _records() if done else None
    if not recs:
        return None
    try:
        roots = [r for r in recs if r.parent == 0]
        by_request: Dict[int, List] = {}
        for r in recs:
            by_request.setdefault(r.request, []).append(r)
        out = []
        for d in done:
            lo = int(d.t0 * 1e9) - SLACK_NS
            hi = int(d.t1 * 1e9) + SLACK_NS
            inside = [r.request for r in roots
                      if lo <= r.start and 0 < r.end <= hi]
            if not inside:
                return None
            out.append([s for q in inside for s in by_request[q]])
        return out
    except AttributeError:          # records of another shape
        return None


def _self_ns(recs) -> Dict[int, int]:
    own = {r.id: r.end - r.start for r in recs}
    for r in recs:
        if r.parent in own:
            own[r.parent] -= r.end - r.start
    return own


def self_ms(data, name: str) -> Optional[float]:
    """Mean self time a profiled request of the spans named `name`, in
    ms; None where no profiled request holds such a span."""
    reqs = per_request(data)
    if not reqs or not any(r.name == name for req in reqs for r in req):
        return None
    total = 0
    for req in reqs:
        own = _self_ns(req)
        total += sum(own[r.id] for r in req if r.name == name)
    return total / len(reqs) / 1e6


def calls(data, name: str) -> Optional[float]:
    """Mean number of spans named `name` a profiled request."""
    reqs = per_request(data)
    if not reqs or not any(r.name == name for req in reqs for r in req):
        return None
    return sum(r.name == name for req in reqs for r in req) / len(reqs)


def counter(data, name: str) -> Optional[int]:
    """The counter `name` summed over every span of the profiled
    requests; None where none counted it."""
    reqs = per_request(data)
    if not reqs:
        return None
    vals = [r.counts[name] for req in reqs for r in req
            if r.counts and name in r.counts]
    return sum(vals) if vals else None


def share(data, part: str, whole: str) -> Optional[float]:
    """100 * counter `part` over counter `whole`, in %."""
    num, den = counter(data, part), counter(data, whole)
    if num is None or not den:
        return None
    return 100.0 * num / den
