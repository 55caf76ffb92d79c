"""Shared by the section readers: the traced window's requests, which ran
under the section clock and not under the profiler."""


def timed_requests(data):
    if not data.traced:
        return []
    return [d for d in data.done if not d.profiled and d.error is None]


def section_ms(data, name):
    """Mean self time a request of section `name`; None when no request
    called into it."""
    reqs = timed_requests(data)
    if not any(name in d.sections for d in reqs):
        return None
    return sum(d.sections.get(name, 0.0) for d in reqs) / len(reqs)
