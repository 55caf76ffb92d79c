"""transcript_ms: the self time of the port's `transcript` spans (every
public method of utils/transcript.py's Transcript: appends and
challenges), mean a profiled request, in ms."""

from benchmark.core.spans import self_ms


def read(data):
    return self_ms(data, "transcript")
