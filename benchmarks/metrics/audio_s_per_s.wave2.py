"""``audio_s_per_s`` in the serving cells whose streams outnumber the
card's active clusters, so that the sampler runs in a second wave: the
same reading, under a name of its own so that its bound follows these
cells' spread (1.3% at 16 streams) and not that of the cells at or under
the cluster limit (3-10% at 15)."""

from benchmarks import common


def read(rec, ctx):
    return common.reader("audio_s_per_s").read(rec, ctx)
