"""Median over the window's words of first audio: the sink's receipt of a
word's first audio minus the due time of the earliest packet of the call
that closed its segment (host clock)."""

from benchmarks.common import pct


def read(rec, ctx):
    return pct(rec.get("first_audio_ms", ()), 50)
