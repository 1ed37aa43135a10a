"""The harness's arithmetic against numbers worked by hand: percentiles,
spreads, the busy union and idle gaps of a trace, the roofline counts of
PERF.md's kernel table."""

from __future__ import annotations

import numpy as np
import pytest

from benchmarks import common, roofline
from benchmarks.trace import device_seconds, summarize


def test_bm_percentiles():
    xs = [1.0, 2.0, 3.0, 4.0, 10.0]
    assert common.pct(xs, 50) == 3.0
    assert common.pct(xs, 95) == pytest.approx(4.0 + 0.8 * 6.0)  # 8.8
    assert common.pct([], 50) is None


def test_bm_spread():
    # statistics.quantiles([1..8], n=4) (exclusive): 2.25, 4.5, 6.75
    assert common.spread([1, 2, 3, 4, 5, 6, 7, 8]) == pytest.approx(1.0)


def test_bm_union():
    assert common.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert common.union_length([]) == 0


def test_bm_trace_summary():
    ev = [dict(ph="X", cat="kernel", name="a", ts=0.0, dur=10.0),
          dict(ph="X", cat="kernel", name="b", ts=5.0, dur=10.0),
          dict(ph="X", cat="gpu_memcpy", name="c", ts=40.0, dur=10.0),
          dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
               ts=0.0, dur=100.0)]
    s = summarize(ev, 1e-4)
    assert s["busy_s"] == pytest.approx(25e-6)   # 0-15 and 40-50
    assert s["idle_gaps"][0] == ["b -> c", pytest.approx(25e-6)]
    assert device_seconds(s, "a") == (1, pytest.approx(10e-6))


@pytest.fixture(scope="module")
def shipped_kept():
    with np.load(common.ROOT / "weights" / "vocoder_speech.npz") as f:
        return roofline.kept_tiles(f["gru_a_mask"])


def test_bm_k2_bound(shipped_kept):
    """K2 at B = 1 x 50 frames: 0.0358 ms, bound by operations."""
    nbytes, flops = roofline.k2(1, 50, shipped_kept)
    assert round(shipped_kept, 3) == 0.199
    assert flops / roofline.PEAK_F32_FLOPS > nbytes / roofline.PEAK_BYTES_PER_S
    assert roofline.least_seconds(nbytes, flops) * 1e3 == \
        pytest.approx(0.0358, abs=5e-5)
    assert roofline.least_seconds(*roofline.k2(15, 50, shipped_kept)) == \
        pytest.approx(15 * roofline.least_seconds(nbytes, flops), rel=1e-3)


def test_bm_frontend_bound():
    """The front-end kernel at 40 samples: 48,512 bytes, 1.45e-5 ms."""
    nbytes, flops = roofline.frontend(40)
    assert nbytes == 48512
    assert roofline.least_seconds(nbytes, flops) * 1e3 == \
        pytest.approx(1.45e-5, abs=5e-8)
    # 320 samples: bound by operations, 4.49e-5 ms
    assert roofline.least_seconds(*roofline.frontend(320)) * 1e3 == \
        pytest.approx(4.49e-5, abs=2e-7)


def test_bm_d1_bound():
    """D1 at 260 frames: 7.73e-5 ms, bound by operations."""
    assert roofline.least_seconds(*roofline.d1(260)) * 1e3 == \
        pytest.approx(7.73e-5, abs=5e-8)


def test_bm_lstm_flops():
    # one frame of the nVAD: 2*4*150*(64+150) + 2*4*150*300 + 2*150*2
    assert roofline.nvad(1) == 256800 + 360000 + 600
