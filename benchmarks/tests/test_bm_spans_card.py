"""On the card: device operations launched inside a span are joined to
that span through their correlation ids and the span's anchor on the
profiler's clock (CUDA activity only, as the benchmark traces), and a
short traced run of each cell reads every span metric of its kind.
Skips without a card.

    python -m pytest -m cuda benchmarks/tests/test_bm_spans_card.py
"""

from __future__ import annotations

import json

import pytest

from benchmarks import span_run, spans

pytestmark = pytest.mark.cuda

SECONDS = {"dsp_session": 8, "b1_session": 8, "b8_session": 8,
           "b1_serve15": 4}
SESSION = ("graph.fe_wait_ms_p50", "units.fe_launch_ms_p50",
           "models.decode_launch_ms_p50", "models.decode_kernels_p50",
           "device.word_head_idle_ms_p50")
SERVE = ("vocoder.noise_ms_per_step", "vocoder.launch_ms_per_step")


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


def test_bm_kernels_join_their_span(card, tmp_path):
    import torch

    from dss_tpu_torch.utils import tracing

    a = torch.randn(512, 512, device="cuda")
    (a @ a).sum().item()
    t = span_run.SpanTrace(str(tmp_path), profile=True)
    t.start()
    try:
        with tracing.span("inside"):
            for _ in range(3):
                (a @ a).add_(1.0)
        torch.cuda.synchronize()
        (a * 2.0).sum()
        torch.cuda.synchronize()
        t.stop()
        t.finish(1.0)
    finally:
        t.close()
    joined = spans.join(t.events)
    inside = [op for op, s in joined if s and s["name"] == "inside"]
    outside = [op for op, s in joined if s is None]
    assert len(inside) >= 6, [(op["name"], s) for op, s in joined]
    assert len(outside) >= 2
    assert all(op["cat"] == "kernel" for op in inside)


@pytest.mark.parametrize("workload", sorted(SECONDS))
def test_bm_traced_run_reads_every_span_metric(card, capsys, workload):
    rc = span_run.main(["--workload", workload, "--seed", "4294967311",
                        "--seconds", str(SECONDS[workload]), "--trace", "1"])
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["dropped"] == 0
    want = SERVE if workload == "b1_serve15" else SESSION
    assert all(line["spans"][m] for m in want), line["spans"]
    assert all(" | host: " in g for g, _ in line["idle_gaps"])
    for t in line["timers"].values():
        assert t["span_ms_p50"] == pytest.approx(t["timer_ms_p50"], rel=0.05)
