"""On the card: each cell for a short window comes out correct on the
program's numbers, and the bfloat16 control in its place comes out not
correct at every stage.  Skips without a card.

    python -m pytest -m cuda benchmarks/tests/test_bm_card.py
"""

from __future__ import annotations

import json

import pytest

from benchmarks import run

pytestmark = pytest.mark.cuda

SECONDS = {"dsp_session": 8, "b1_session": 8, "b8_session": 8,
           "b1_serve15": 4}


@pytest.fixture(scope="module")
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


@pytest.mark.parametrize("workload", sorted(SECONDS))
def test_bm_cell_on_the_card(card, capsys, workload):
    rc = run.main(["--workload", workload, "--seed", "4294967311",
                   "--seconds", str(SECONDS[workload]), "--control", "1"])
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert all(c["value"] <= c["limit"] for c in line["checks"].values()), \
        line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["correct"] is False
    assert not any(s["correct"] for s in line["control"].values()), \
        line["control"]
