"""kernel_roofline_share: the least time the card could take for the
profiled requests' work, counted from their sizes (core/roofline.py),
over all the device time of those requests, in %."""

from benchmark.core import roofline


def read(data):
    p = data.profile
    if not p or p["device_s"] <= 0:
        return None
    bound = sum(roofline.bound_seconds(d.work)
                for d in data.done if d.profiled and d.work)
    return 100.0 * bound / p["device_s"] if bound else None
