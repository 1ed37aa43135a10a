"""Median per word of RecurrentNeuralDecodingModel.decode_ms: the unit's
host clock around a segment's decode and its read back."""

from benchmarks.common import pct


def read(rec, ctx):
    return pct(rec.get("decode_ms") or (), 50)
