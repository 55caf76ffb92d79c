"""host_rest_ms: a request's wall less every section's self time: the host
logic of models/ and parallel/ (transcript, Fr algebra, single-point group
operations) and what the sections do not cover; mean a request, in ms."""

from benchmark.core.readers import timed_requests


def read(data):
    reqs = timed_requests(data)
    if not reqs or not any(d.sections for d in reqs):
        return None
    return sum(d.seconds * 1e3 - sum(d.sections.values())
               for d in reqs) / len(reqs)
