"""Median per word of the word path's head: FusedDecoderVocoder.word_ms
(decode and first chunk up to its read), or on the separate chain the
word's decode_ms + vocode_ms (the units' own host clocks)."""

from benchmarks.common import pct


def read(rec, ctx):
    return pct(rec.get("word_head_ms") or (), 50)
