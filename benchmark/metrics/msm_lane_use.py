"""msm_lane_use: the bases with a non-zero scalar over the base lanes
launched by ops/curve's MSMs and batched scalar multiplication (its
counters `msm.terms` and `msm.lanes`: rows x padded width), over the
profiled requests, in %."""

from benchmark.core.spans import share


def read(data):
    return share(data, "msm.terms", "msm.lanes")
