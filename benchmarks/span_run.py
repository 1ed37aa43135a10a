"""One run of one benchmark cell with the port's span recorder on over the
window, and the span metrics read from it.

    python3 benchmarks/span_run.py --workload CELL --seed N --seconds S --trace 0|1

The cell runs as ``benchmarks/run.py`` runs it (the same runner, inputs and
check), with one change: ``dss_tpu_torch.utils.tracing`` is switched on
when the window starts and off when it ends.  ``--trace 1`` also records
the window's device trace as ``run.py --trace 1`` does (CUDA activity
only), joins every device operation to the span that launched it
(``benchmarks/spans.py``) and names the ten longest idle gaps by the host
span open in them; ``--trace 0`` leaves the profiler off, so its
end-to-end numbers show what the recorder costs when it is on (against
``run.py --trace 0``).

The last line of standard output is one JSON object: ``correct``, the
cell's metrics (end-to-end and per-layer, as the run can read them), the
span metrics (``spans``), the packet path's steps (``packet_path``), each
span's median and count (``span_ms_p50``), the spans' medians beside the
units' own timers (``timers``), how many records the recorder's ring lost
(``dropped``) and, with ``--trace 1``, the labelled idle gaps."""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common, run, spans  # noqa: E402
from benchmarks.trace import DEVICE_CATS, DeviceTrace, summarize  # noqa: E402


class SpanTrace(DeviceTrace):
    """The runner's window hooks: the recorder on over the window and, with
    ``profile``, the device trace, whose events are kept with the spans
    written into them on the trace's clock."""

    def __init__(self, out_dir: str, profile: bool):
        super().__init__(out_dir)
        self.profile = profile
        self.events = []
        self.records = []

    def start(self) -> None:
        from dss_tpu_torch.utils import tracing
        tracing.drain()
        tracing.enable()
        self.anchor = tracing.Anchor()
        if self.profile:
            super().start()

    def stop(self) -> None:
        from dss_tpu_torch.utils import tracing
        if self.profile:
            super().stop()
        tracing.disable()

    def close(self) -> None:
        from dss_tpu_torch.utils import tracing
        super().close()
        tracing.disable()

    def finish(self, window_s: float):
        from dss_tpu_torch.utils import tracing
        self.records = tracing.drain()
        if not self.profile:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "window.pt.trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        try:
            with open(path) as fd:
                trace = json.load(fd)
        finally:
            os.remove(path)
        events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        self.summary = summarize(events, window_s)
        self.events = events + tracing.chrome_events(
            self.records, self.anchor, trace["baseTimeNanoseconds"],
            os.getpid())
        return self.summary


def timers(rec: dict, records) -> dict:
    """Median of each unit timer beside the median of the span that
    should time the same interval (ms)."""
    pairs = (("fe_step_ms", "units.fe_call"),
             ("word_head_ms", "units.word_head"),
             ("decode_ms", "units.decode"),
             ("vocode_ms", "units.vocode"))
    out = {}
    for timer, name in pairs:
        ms = [(r.end_ns - r.start_ns) * 1e-6 for r in records
              if r.name == name]
        if rec.get(timer) and ms:
            out[name] = dict(span_ms_p50=common.pct(ms, 50),
                             timer_ms_p50=common.pct(rec[timer], 50),
                             n_spans=len(ms), n_timer=len(rec[timer]))
    return out


def main(argv=None, device=None) -> int:
    """``device`` None: the card, required; a test passes "cpu"."""
    args = run.parse(argv)
    run.fixed_caches()
    bench = common.benchmark()
    entry, config, traffic = common.cell(bench, args.workload)
    import torch
    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available():
            print(f"{args.workload} needs a CUDA device", file=sys.stderr)
            return 2
        device = "cuda"
    run_dir = Path(tempfile.gettempdir()) / "dss_bench_spans" / args.workload
    trace = SpanTrace(str(run_dir), profile=bool(args.trace))
    ctx = dict(args=args, bench=bench, entry=entry, config=config,
               traffic=traffic, device=device, t_start=run.T_START,
               run_dir=str(run_dir), trace=trace)
    try:
        rec = common.runner(traffic).run(ctx)
    finally:
        trace.close()
        shutil.rmtree(run_dir, ignore_errors=True)
    metrics = {}
    for kind in ("end_to_end", "per_layer"):
        for m in common.metrics_of(bench, args.workload, kind):
            value = common.reader(m["name"]).read(rec, ctx)
            if value is not None:
                metrics[m["name"]] = value
    line = dict(workload=args.workload, seed=args.seed, trace=args.trace,
                correct=run.verdict(rec["checks"]), metrics=metrics,
                timers=timers(rec, trace.records),
                n_spans=len(trace.records), dropped=trace.records.dropped)
    events = trace.events
    if not events:   # the spans alone, on the Unix clock
        from dss_tpu_torch.utils import tracing
        events = tracing.chrome_events(trace.records, trace.anchor, 0,
                                       os.getpid())
    line["spans"] = spans.span_metrics(events)
    line["packet_path"] = spans.packet_path(spans.spans_of(events))
    line["span_ms_p50"] = spans.span_medians(spans.spans_of(events))
    if trace.events:
        line["idle_gaps"] = spans.idle_gaps(events)
        line["launch_events"] = sum(e.get("cat") in spans.LAUNCH_CATS
                                    for e in events)
        line["device_events"] = sum(e.get("cat") in DEVICE_CATS
                                    for e in events)
    if device == "cuda":
        line["device"] = torch.cuda.get_device_name(0)
        line["power_limit_w"] = run.power_limit()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
