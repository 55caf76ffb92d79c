"""device_idle_share: 1 - the card's busy time a profiled request (the
seconds in which it ran an operation, torch.profiler) over the mean wall of
the traced window's requests, in %. Those ran under the section clock and
not under the profiler, whose own costs would count as idle."""

from benchmark.core.readers import timed_requests


def read(data):
    p = data.profile
    reqs = timed_requests(data)
    if not p or not reqs:
        return None
    wall = sum(d.seconds for d in reqs) / len(reqs)
    return 100.0 * (1.0 - p["busy_s"] / p["requests"] / wall)
