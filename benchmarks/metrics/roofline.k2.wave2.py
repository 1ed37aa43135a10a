"""``roofline.k2.serve`` in the serving cells past the cluster limit
(``audio_s_per_s.wave2``'s cells): the same reading."""

from benchmarks import common


def read(rec, ctx):
    return common.reader("roofline.k2.serve").read(rec, ctx)
