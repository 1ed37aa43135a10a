"""``vocoder.host_ms_per_step`` in the serving cells past the cluster
limit (``audio_s_per_s.wave2``'s cells): the same reading."""

from benchmarks import common


def read(rec, ctx):
    return common.reader("vocoder.host_ms_per_step").read(rec, ctx)
