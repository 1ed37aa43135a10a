"""Median over every packet due in the window of the packet step: the
feature tap's receipt of the packet's frames minus the packet's due time
(host clock).  It counts the source's lateness, queueing, coalescing and
the packet call."""

from benchmarks.common import pct


def read(rec, ctx):
    return pct(rec.get("packet_lat_ms", ()), 50)
