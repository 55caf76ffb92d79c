"""verify_ms_p95: the 95th percentile of the latencies of all the window's
completed requests (host clock, each from its call to its verdict on the
host), in ms. A request that failed fails the run's check."""

import statistics


def read(data):
    lat = [d.seconds * 1e3 for d in data.done if d.error is None]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
