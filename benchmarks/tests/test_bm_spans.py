"""The span readers (benchmarks/spans.py) on a synthetic trace, and one
short CPU run of benchmarks/span_run.py.

    python -m pytest benchmarks/tests -q
"""

from __future__ import annotations

import pytest

from benchmarks import spans

LOOP, WORKER = 11, 22


def _span(name, ts, end, sid, tid=WORKER, parent=None, key=None, **counts):
    args = dict(counts, id=sid)
    if parent is not None:
        args["parent"] = parent
    if key is not None:
        args["key"] = key
    return dict(ph="X", cat=spans.SPAN_CAT, name=name, tid=tid, ts=ts,
                dur=end - ts, args=args)


def _launch(ts, corr, tid=WORKER):
    return dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", tid=tid,
                ts=ts, dur=2.0, args=dict(correlation=corr))


def _op(name, ts, end, corr, cat="kernel"):
    return dict(ph="X", cat=cat, name=name, tid=7, ts=ts, dur=end - ts,
                args=dict(correlation=corr))


def _trace():
    """Times in us.  Two packets waiting on the packet path's edge (and
    one on a logger's) and their one call; a word's head with its decode;
    a serving step's synthesis with its noise; six device operations."""
    fe = spans.FE_EDGE
    return [
        _span("graph.wait", 50, 90, 1, LOOP, key=1.0, place=0, edge=fe),
        _span("graph.wait", 60, 95, 2, LOOP, key=2.0, place=1, edge=fe),
        _span("graph.wait", 52, 400, 3, LOOP, key=1.0, place=0,
              edge="BinaryLogger.INPUT"),
        _span("units.fe_call", 100, 200, 4, key=1.0, packets=2),
        _span("units.fe_launch", 110, 150, 5, parent=4, key=1.0),
        _span("units.word_head", 1000, 2000, 6, key=500.0, frames=80),
        _span("models.decode", 1010, 1500, 7, parent=6, key=500.0,
              frames=80, padded_frames=100),
        _span("models.decode", 900, 950, 8, frames=99, padded_frames=100),
        _span("vocoder.synth", 3000, 3500, 9, streams=15, frames=50),
        _span("vocoder.noise", 3100, 3200, 10, parent=9),
        _launch(120, 1), _launch(1100, 2), _launch(1200, 3),
        _launch(1600, 4), _launch(3150, 5), _launch(5000, 6),
        _op("k1", 130, 140, 1), _op("k2", 1150, 1250, 2),
        _op("k3", 1300, 1400, 3, cat="gpu_memcpy"), _op("k4", 1700, 1800, 4),
        _op("k5", 3160, 3300, 5), _op("k6", 5010, 5020, 6),
        _op("k7", 6000, 6010, 99),   # its launch is not in the trace
    ]


def test_bm_spans_join_by_correlation_and_thread():
    got = {op["name"]: (s["name"] if s else None)
           for op, s in spans.join(_trace())}
    assert got == {"k1": "units.fe_launch", "k2": "models.decode",
                   "k3": "models.decode", "k4": "units.word_head",
                   "k5": "vocoder.noise", "k6": None, "k7": None}


def test_bm_spans_join_by_pthread_id():
    """A trace of CUDA activity alone names a launch's thread by its
    pthread id (cut to 32 bits), which a span carries as ``ident``."""
    sp = _span("models.decode", 100, 200, 1, key=3.0)
    sp["args"]["ident"] = 152124672
    trace = [sp, _launch(150, 1, tid=152124672), _op("k", 160, 170, 1),
             _launch(250, 2, tid=152124672), _op("k2", 260, 270, 2)]
    got = [(op["name"], s["name"] if s else None)
           for op, s in spans.join(trace)]
    assert got == [("k", "models.decode"), ("k2", None)]


def test_bm_spans_packet_path():
    trace = _trace() + [
        _span("units.fe_segment", 230, 260, 11, LOOP, key=1.0, packets=2),
        _span("graph.wait", 240, 250, 12, LOOP, key=1.0, place=0,
              edge="FeatureTap.INPUT")]
    got = spans.packet_path(spans.spans_of(trace))
    want = dict(wait=0.0375, to_call=0.0075, call=0.1, to_segment=0.03,
                segment=0.03, tap_wait=0.01)
    assert got == pytest.approx(want)
    assert spans.span_medians(spans.spans_of(trace))["models.decode"] == \
        [pytest.approx(0.27), 2]


def test_bm_spans_innermost_nests_by_thread():
    trace = _trace()
    found = spans.innermost(spans.spans_of(trace),
                            [(WORKER, 1200), (WORKER, 1600), (WORKER, 2500),
                             (LOOP, 70), (99, 1200), (WORKER, 1500)])
    assert [s["name"] if s else None for s in found] == \
        ["models.decode", "units.word_head", None, None, None,
         "units.word_head"]


def test_bm_spans_metrics():
    m = spans.span_metrics(_trace())
    assert m["graph.fe_wait_ms_p50"] == pytest.approx(0.045)
    assert m["units.fe_launch_ms_p50"] == pytest.approx(0.04)
    assert m["models.decode_launch_ms_p50"] == pytest.approx(0.49)
    assert m["models.decode_kernels_p50"] == 2
    assert m["device.word_head_idle_ms_p50"] == pytest.approx(0.7)
    assert m["vocoder.noise_ms_per_step"] == pytest.approx(0.14)
    assert m["vocoder.launch_ms_per_step"] == pytest.approx(0.5)


def test_bm_spans_metrics_without_device_operations():
    host = [e for e in _trace() if e["cat"] == spans.SPAN_CAT]
    m = spans.span_metrics(host)
    assert m["graph.fe_wait_ms_p50"] == pytest.approx(0.045)
    assert m["models.decode_kernels_p50"] is None
    assert m["device.word_head_idle_ms_p50"] is None
    assert m["vocoder.noise_ms_per_step"] is None
    assert spans.span_metrics([]) == dict.fromkeys(m)


def test_bm_spans_head_of_the_separate_chain():
    trace = [_span("units.decode", 100, 400, 1, key=7.0),
             _span("units.vocode", 420, 600, 2, tid=33, key=7.0),
             _span("units.decode", 900, 950, 3, key=8.0),   # no vocode yet
             _op("k", 200, 300, 1), _op("k", 450, 500, 2)]
    assert spans.head_intervals(spans.spans_of(trace)) == [(100, 600)]
    m = spans.span_metrics(trace)
    assert m["device.word_head_idle_ms_p50"] == pytest.approx(0.35)


def test_bm_spans_idle_gaps_name_the_host():
    gaps = spans.idle_gaps(_trace())
    assert [round(us * 1e6) for _, us in gaps] == [1710, 1360, 1010, 980,
                                                   300, 50]
    assert [g.split(" | host: ")[1] for g, _ in gaps] == \
        ["none"] * 4 + ["units.word_head", "models.decode"]
    assert gaps[4][0] == "k3 -> k4 | host: units.word_head"
    assert gaps[5][0] == "k2 -> k3 | host: models.decode"
    assert len(spans.idle_gaps(_trace(), top=2)) == 2


def test_bm_span_run_on_the_cpu(capsys):
    """A short dsp_session with the recorder on and the CPU profiler: the
    check passes, no record is lost, the spans time what the units' lists
    time, and the host span metrics read."""
    import json

    from benchmarks import span_run
    rc = span_run.main(["--workload", "dsp_session", "--seed", "2147483659",
                        "--seconds", "6", "--trace", "1"], device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["dropped"] == 0
    assert set(line["timers"]) == {"units.fe_call", "units.decode",
                                   "units.vocode"}
    for t in line["timers"].values():
        assert t["span_ms_p50"] == pytest.approx(t["timer_ms_p50"], rel=0.05)
    for name in ("graph.fe_wait_ms_p50", "units.fe_launch_ms_p50",
                 "models.decode_launch_ms_p50"):
        assert line["spans"][name] > 0
