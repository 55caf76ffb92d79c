"""fetches_per_request: the port's `fetch` spans a profiled request: the
blocking device-to-host copies, each one a point where the host waits for
the card."""

from benchmark.core.spans import calls


def read(data):
    return calls(data, "fetch")
