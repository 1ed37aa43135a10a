"""The harness's arithmetic against numbers worked by hand: percentiles,
spreads, the busy union and idle gaps of a trace, the roofline counts of
PERF.md's kernel table, and the readers that divide them by a trace's
device time."""

from __future__ import annotations

import numpy as np
import pytest

from benchmarks import common, roofline
from benchmarks.metrics_support import kept_tiles
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


@pytest.fixture(scope="module")
def b8_kept():
    with np.load(common.ROOT / "weights" / "vocoder_speech_b8.npz") as f:
        return roofline.kept_tiles(f["gru_a_mask"])


@pytest.mark.parametrize("S,B,ms", [(2, 1, 0.0202), (4, 1, 0.0124),
                                     (8, 1, 0.0085), (4, 8, 0.0991)])
def test_bm_k3_bound(b8_kept, S, B, ms):
    """K3 a 50-frame block at the kernel table's bounds (operations), b8
    within 10% of its 0.0085 ms."""
    nbytes, flops = roofline.k3(B, 50, S, b8_kept)
    assert flops / roofline.PEAK_F32_FLOPS > nbytes / roofline.PEAK_BYTES_PER_S
    least = roofline.least_seconds(nbytes, flops) * 1e3
    assert least == pytest.approx(ms, rel=0.1)
    assert least == pytest.approx(ms, abs=6e-5)


def test_bm_mfu_word_at_bunch_1_as_before():
    """mfu.word on a fixed bunch-1 record reads what it read before the
    bunched count was added (and the DSP path likewise)."""
    ctx = dict(config=common.load_json(common.HERE / "configs" /
                                       "lpcnet_b1.json"))
    rec = dict(kind="session", vocoder="net", word_frames=[137, 250, 90],
               word_span_s=[0.2, 0.3, 0.15])
    mfu = common.reader("mfu.word")
    assert mfu.read(rec, ctx) == pytest.approx(0.05593332904707233,
                                               rel=1e-12)
    assert mfu.read(dict(rec, vocoder="dsp"), ctx) == \
        pytest.approx(0.000843860941446613, rel=1e-12)
    b8 = dict(config=common.load_json(common.HERE / "configs" /
                                      "lpcnet_b8.json"))
    chunks = 3 + 5 + 2
    k3 = roofline.k3(1, 50, 8, kept_tiles(b8))[1]
    dec = sum(roofline.decoder(T) for T in rec["word_frames"])
    assert mfu.read(rec, b8) == pytest.approx(
        100.0 * (dec + chunks * k3) / 0.65 / roofline.PEAK_F32_FLOPS)


# The sampler kernels' names as the device trace records them (b8 and b1
# word paths on an H100).
K3_B8 = "void (anonymous namespace)::lpcnet_sampler_kernel<8>" \
        "((anonymous namespace)::Args)"
K2_B1 = "void (anonymous namespace)::lpcnet_sampler_kernel<1>" \
        "((anonymous namespace)::Args)"


def test_bm_k3_word_reads_the_kernel_at_its_bunch(b8_kept):
    """roofline.k3.word takes the kernel instantiated at the cell's S and no
    other: the least time of a 50-frame chunk a launch over the launches'
    device time."""
    by_name = {K3_B8: (4, 0.036), K2_B1: (2, 0.048),
               "bilstm_decoder_kernel": (4, 0.001)}
    rec = dict(kind="session", vocoder="net",
               trace=dict(by_name=by_name, busy_s=0.1, window_s=1.0))
    ctx = dict(config=common.load_json(common.HERE / "configs" /
                                       "lpcnet_b8.json"))
    least = roofline.least_seconds(*roofline.k3(1, 50, 8, b8_kept))
    share = common.reader("roofline.k3.word").read(rec, ctx)
    assert share == pytest.approx(100.0 * least * 4 / 0.036)
    b1 = dict(config=common.load_json(common.HERE / "configs" /
                                      "lpcnet_b1.json"))
    assert common.reader("roofline.k3.word").read(rec, b1) is None


def test_bm_decoder_roofline_reads_d3():
    """roofline.decoder: the mean least time of the words' decodes (float32
    operations at the peak) a launch of D3 over the launches' device
    time."""
    by_name = {"(anonymous namespace)::bilstm_decoder_kernel("
               "(anonymous namespace)::Params)": (2, 0.0006)}
    rec = dict(kind="session", word_frames=[137, 250, 90],
               trace=dict(by_name=by_name, busy_s=0.1, window_s=1.0))
    least = sum(roofline.decoder(T) for T in (137, 250, 90)) / 3 \
        / roofline.PEAK_F32_FLOPS
    assert common.reader("roofline.decoder").read(rec, {}) == \
        pytest.approx(100.0 * least * 2 / 0.0006)
    assert roofline.decoder(137) / roofline.PEAK_F32_FLOPS * 1e3 == \
        pytest.approx(0.0015, abs=5e-5)


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
