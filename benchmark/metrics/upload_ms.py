"""upload_ms: the wall time of the port's `upload` spans that are children
of a `device_prove` span (the device prover's one upload of its inputs,
tables and draws before the chain), mean a profiled request, in ms."""

from benchmark.core.spans import per_request


def read(data):
    reqs = per_request(data)
    if not reqs:
        return None
    ns, seen = 0, False
    for req in reqs:
        provers = {r.id for r in req if r.name == "device_prove"}
        for r in req:
            if r.name == "upload" and r.parent in provers:
                ns += r.end - r.start
                seen = True
    return ns / len(reqs) / 1e6 if seen else None
