"""Median of FusedFrontendVad.step_ms: the unit's own host clock around a
packet call (copy in, front end and nVAD, the one read back)."""

from benchmarks.common import pct


def read(rec, ctx):
    return pct(rec.get("fe_step_ms") or (), 50)
