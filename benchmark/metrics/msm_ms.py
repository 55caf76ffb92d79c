"""msm_ms: host clock, synchronised on both sides, around each call into
ops/curve's MSM entry points (msm_with_static, msm, StackedVec.msm_many,
batch_scalar_mul); self time a request, in ms."""

from benchmark.core.readers import section_ms


def read(data):
    return section_ms(data, "msm")
