"""fetch_wait_ms: the self time of the port's `fetch` spans, each around
one blocking device-to-host copy: the time the host waits for the card to
finish what was enqueued, and the copy; mean a profiled request, in ms."""

from benchmark.core.spans import self_ms


def read(data):
    return self_ms(data, "fetch")
