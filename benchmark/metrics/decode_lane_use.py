"""decode_lane_use: the points decoded over the lanes launched by
ops/codec_batch's batched decompression (its counters `decode.points` and
`decode.lanes`, the batch padded to a power of two), over the profiled
requests, in %."""

from benchmark.core.spans import share


def read(data):
    return share(data, "decode.points", "decode.lanes")
