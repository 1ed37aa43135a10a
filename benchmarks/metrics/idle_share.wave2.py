"""``idle_share.serve`` in the serving cells past the cluster limit
(``audio_s_per_s.wave2``'s cells): the same reading."""

from benchmarks import common


def read(rec, ctx):
    return common.reader("idle_share.serve").read(rec, ctx)
