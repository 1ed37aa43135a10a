"""Process start (the harness's first line) to the first timed work:
imports, inputs, weights, the kernels' build or load, the units'
warm-ups (host clock)."""


def read(rec, ctx):
    return rec["setup_s"]
