"""On the card, ``b1_serve16`` at its own size (16 streams, a short
window): the program's numbers come out correct and the bfloat16 control
in its place comes out not correct; a short traced run is correct and
reads the serving span metrics.  Skips without a card.

    python -m pytest -m cuda benchmarks/tests/test_bm_wave2_card.py
"""

from __future__ import annotations

import json

import pytest

from benchmarks import run, span_run

pytestmark = pytest.mark.cuda

SEED = "4294967311"
SERVE = ("vocoder.noise_ms_per_step", "vocoder.launch_ms_per_step")


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


def _line(capsys, rc):
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_bm_serve16_control_on_the_card(card, capsys):
    line = _line(capsys, run.main(["--workload", "b1_serve16", "--seed",
                                   SEED, "--seconds", "4", "--control",
                                   "1"]))
    assert all(c["value"] <= c["limit"] for c in line["checks"].values()), \
        line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is False
    assert not line["control"]["vocoder"]["correct"], line["control"]


def test_bm_serve16_traced_run_reads_the_serving_spans(card, capsys):
    line = _line(capsys, span_run.main(["--workload", "b1_serve16", "--seed",
                                        SEED, "--seconds", "4", "--trace",
                                        "1"]))
    assert line["correct"] is True and line["dropped"] == 0
    assert all(line["spans"][m] for m in SERVE), line["spans"]
    assert all(" | host: " in g for g, _ in line["idle_gaps"])
    for t in line["timers"].values():
        assert t["span_ms_p50"] == pytest.approx(t["timer_ms_p50"], rel=0.05)
