"""What one span of dss_tpu_torch/utils/tracing.py costs the host: a
``with span(...)`` with two counts, the recorder off and on, timed over
many spans in a loop (a loop with no span subtracted), in nanoseconds a
span.  The recorder's ring is drained between rounds.

    python tools/torch_span_cost.py [--spans 200000] [--rounds 5]

Prints one JSON line: the median and the best round of each case."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dss_tpu_torch.utils import tracing  # noqa: E402


def _empty(n: int) -> int:
    t0 = time.perf_counter_ns()
    for i in range(n):
        pass
    return time.perf_counter_ns() - t0


def _spans(n: int) -> int:
    span = tracing.span
    t0 = time.perf_counter_ns()
    for i in range(n):
        with span("units.fe_call", packets=1, frames=4):
            pass
    return time.perf_counter_ns() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--spans", type=int, default=200_000)
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args(argv)
    n = min(args.spans, tracing.RING)   # no round overwrites the ring
    out = {}
    for case in ("off", "on"):
        per = []
        for _ in range(args.rounds):
            if case == "on":
                tracing.enable()
            try:
                ns = _spans(n) - _empty(n)
            finally:
                tracing.disable()
                tracing.drain()
            per.append(ns / n)
        out[f"{case}_ns_per_span"] = dict(median=statistics.median(per),
                                          best=min(per))
    out["spans_a_round"] = n
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
