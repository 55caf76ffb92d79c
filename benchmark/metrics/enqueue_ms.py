"""enqueue_ms: the wall time of the port's `chain` spans, each around the
host's enqueue of a prover's whole device chain (models/device_common.py
`enqueue`), mean a profiled request, in ms. The card runs the chain while
the host enqueues it; what it has left when the enqueue ends is the wait of
the `fetch` after it."""

from benchmark.core.spans import per_request


def read(data):
    reqs = per_request(data)
    if not reqs or not any(r.name == "chain" for req in reqs for r in req):
        return None
    ns = sum(r.end - r.start for req in reqs for r in req if r.name == "chain")
    return ns / len(reqs) / 1e6
