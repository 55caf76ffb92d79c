"""decode_ms: host clock, synchronised on both sides, around each call
into ops/codec_batch's batch_decompress; self time a request, in ms."""

from benchmark.core.readers import section_ms


def read(data):
    return section_ms(data, "decode")
