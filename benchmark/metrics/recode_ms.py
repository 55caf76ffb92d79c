"""recode_ms: the self time of the port's `recode` spans (the host's GLV
recoding of MSM and scalar-multiplication scalars into signed digits, and
the stacking of those digits, in ops/curve and ops/codec_batch), mean a
profiled request, in ms."""

from benchmark.core.spans import self_ms


def read(data):
    return self_ms(data, "recode")
