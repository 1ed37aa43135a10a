"""The inputs a run makes from its seed: the same seed gives the same
inputs, every seed the same amount of work, seeds beyond 32 bits."""

from __future__ import annotations

import numpy as np

from benchmarks import common, inputs

TRAFFIC = common.load_json(common.HERE / "traffic" / "session_keywords.json")


def test_bm_schedule_repeats_per_seed():
    a = inputs.word_schedule(5, TRAFFIC, 30)
    assert a == inputs.word_schedule(5, TRAFFIC, 30)
    assert a != inputs.word_schedule(6, TRAFFIC, 30)


def test_bm_schedule_same_work_every_seed():
    lengths = [sorted(round(b - a, 9) for a, b in
                      inputs.word_schedule(s, TRAFFIC, 30))
               for s in (1, 2, 2 ** 31 + 7, 2 ** 40)]
    assert all(x == lengths[0] for x in lengths)
    assert len(lengths[0]) >= 10


def test_bm_schedule_fits_the_window():
    for seed in range(20):
        words = inputs.word_schedule(seed, TRAFFIC, 30)
        assert words[0][0] == TRAFFIC["lead_s"]
        assert words[-1][1] <= 30 - TRAFFIC["tail_s"] + 1e-9
        gaps = [b[0] - a[1] for a, b in zip(words, words[1:])]
        assert min(gaps) >= TRAFFIC["gap_s"][0] - 1e-9


def test_bm_session_repeats_per_seed():
    a = inputs.session(2 ** 33 + 1, TRAFFIC, 3)
    b = inputs.session(2 ** 33 + 1, TRAFFIC, 3)
    assert a.shape == (3000, 129) and a.dtype == np.float32
    assert np.array_equal(a, b)


def test_bm_decoder_weights_repeat_per_seed():
    a = inputs.decoder_weights(9, c0_bias=-3.0)
    b = inputs.decoder_weights(9, c0_bias=-3.0)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["regressor.bias"][0] == -3.0
