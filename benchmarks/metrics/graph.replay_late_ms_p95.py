"""95th percentile of how late the replay source published each packet
after it was due (host clock): the event loop held up, or the packet
path's bounded input full."""

from benchmarks.common import pct


def read(rec, ctx):
    return pct(rec.get("replay_late_ms", ()), 95)
