"""Parity of the port's packet front end (dss_tpu_torch.ops) with the JAX
package, on the CPU.

Inputs come from numpy seeds and go through both packages; only numpy
crosses between them.  The JAX Pallas log-power kernel runs in interpret
mode, as tests/test_pallas.py runs it.
"""

import os

os.environ["DSS_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dss_tpu.ops import HighGammaExtractor as JHGA  # noqa: E402
from dss_tpu.ops import log_power_frames as j_log_power_frames  # noqa: E402
from dss_tpu.ops import sosfilt_scan as j_sosfilt_scan  # noqa: E402
from dss_tpu.ops.car import CommonAverageReferencing as JCAR  # noqa: E402
from dss_tpu.ops.car import ZScoreNormalization as JZ  # noqa: E402
from dss_tpu.ops.ringbuffer import SpeechSegmentHistory as JHist  # noqa: E402
from dss_tpu.ops.ringbuffer import \
    VoiceActivityDetectionSmoothing as JSmooth  # noqa: E402
from dss_tpu.utils import channels as jch  # noqa: E402
from dss_tpu_torch.ops import log_power as lp  # noqa: E402
from dss_tpu_torch.ops.car import CommonAverageReferencing, \
    ZScoreNormalization  # noqa: E402
from dss_tpu_torch.ops.filters import sosfilt_scan, sosfilt_zi  # noqa: E402
from dss_tpu_torch.ops.frames import log_power_frames  # noqa: E402
from dss_tpu_torch.ops.hga import HighGammaExtractor  # noqa: E402
from dss_tpu_torch.ops.ringbuffer import SpeechSegmentHistory, \
    VoiceActivityDetectionSmoothing  # noqa: E402
from dss_tpu_torch.utils import channels as tch  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("rows", [90, 437, 3010])
def test_log_power_plain_matches_jax_gather(rng, rows):
    """Port plain version vs the JAX gather path; 3010 rows give 297
    windows (> one 256-window Pallas tile).  atol 1e-5: the same f32
    mean-of-squares, summed in another order."""
    data = rng.normal(size=(rows, 8)).astype(np.float32)
    want = np.asarray(j_log_power_frames(jnp.asarray(data), 1000, 0.05, 0.01,
                                         use_pallas=False))
    got = log_power_frames(_t(data), 1000, 0.05, 0.01).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("rows", [80, 3010])
def test_log_power_plain_matches_jax_pallas_interpret(rng, rows,
                                                      monkeypatch):
    """Port plain version vs the Pallas kernel in interpret mode
    (hop-group sums); atol 1e-5 for the different summation order."""
    import dss_tpu.ops.pallas.log_power as jlp

    monkeypatch.setattr(jlp, "_INTERPRET", True)
    data = rng.normal(size=(rows, 64)).astype(np.float32)
    want = np.asarray(j_log_power_frames(jnp.asarray(data), 1000, 0.05, 0.01,
                                         use_pallas=True))
    got = log_power_frames(_t(data), 1000, 0.05, 0.01).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_log_power_wrapper_rules(rng):
    """Eligible geometry counts no launch on the CPU (the plain version
    runs); ineligible geometry is refused by the wrapper and taken by the
    gather form in log_power_frames (12 ms windows at a 5 ms hop)."""
    data = _t(rng.normal(size=(200, 4)))
    before = lp.log_power.launches
    log_power_frames(data, 1000, 0.05, 0.01)
    assert lp.log_power.launches == before
    with pytest.raises(ValueError):
        lp.log_power(data, np.array([0, 5, 10]), 12)
    got = log_power_frames(data, 1000, 0.012, 0.005).numpy()
    want = np.asarray(j_log_power_frames(jnp.asarray(data.numpy()), 1000,
                                         0.012, 0.005, use_pallas=False))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sosfilt_scan_matches_jax(rng):
    """The wavefront cascade vs the JAX sequential scan, 16 sections, with
    the hga initial state; chunked (two calls) == one call.  atol 1e-5:
    identical per-element arithmetic in f32, fused differently by XLA."""
    ex = JHGA(fs=1000, nb_electrodes=6)
    x = rng.normal(size=(120, 6)).astype(np.float32)
    zi = np.asarray(ex._zi0, np.float32)
    y_j, zf_j = j_sosfilt_scan(jnp.asarray(ex.sos, jnp.float32),
                               jnp.asarray(x), jnp.asarray(zi))
    sos = torch.as_tensor(ex.sos, dtype=torch.float32)
    y, zf = sosfilt_scan(sos, _t(x), _t(zi))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(zf.numpy(), np.asarray(zf_j), atol=1e-5)
    y1, z1 = sosfilt_scan(sos, _t(x[:7]), _t(zi))
    y2, z2 = sosfilt_scan(sos, _t(x[7:]), z1)
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), y.numpy(),
                               atol=1e-6)
    tx = HighGammaExtractor(fs=1000, nb_electrodes=6, device=CPU)
    np.testing.assert_array_equal(tx._zi0, ex._zi0)
    np.testing.assert_array_equal(tx.sos_np, ex.sos)
    from dss_tpu.ops.filters import sosfilt_zi as j_sosfilt_zi
    np.testing.assert_array_equal(sosfilt_zi(ex.sos[:8], 6),
                                  j_sosfilt_zi(ex.sos[:8], 6))


def _transforms(pkg):
    """The deployed pre/post transform chain built from either package."""
    ch = jch if pkg == "jax" else tch
    car_cls, z_cls = (JCAR, JZ) if pkg == "jax" else \
        (CommonAverageReferencing, ZScoreNormalization)
    rng = np.random.default_rng(3)
    means = rng.normal(size=(1, 64)).astype(np.float32) * 0.1
    stds = (1.0 + rng.random(size=(1, 64))).astype(np.float32)
    pre = [ch.SelectElectrodesFromBothGrids(),
           car_cls(exclude_channels=[19, 38, 48, 52],
                   grids=[ch.speech_grid(), ch.motor_grid()],
                   layout=ch.default_layout()),
           ch.SelectElectrodesOverSpeechAreas()]
    return pre, [z_cls(means, stds)]


def test_channel_tables_match():
    """The copied electrode tables equal the reference's, bit for bit."""
    np.testing.assert_array_equal(tch.BOTH_GRIDS_ORDER, jch.BOTH_GRIDS_ORDER)
    np.testing.assert_array_equal(tch.SPEECH_AREA_CHANNELS,
                                  jch.SPEECH_AREA_CHANNELS)
    assert len(tch.SelectElectrodesOverSpeechAreas()) == 64


def test_packet_step_chunked_matches_offline_and_jax(rng):
    """Full deployed chain (129 raw -> 64 channels): port packet_step over
    40-sample packets (first packet's warm-up frames dropped) == the port's
    offline extract_features == JAX packet_step.  atol 1e-4: log power of
    IIR output after 16 sections and z-scoring, f32 on both sides."""
    raw = rng.normal(size=(400, 129)).astype(np.float32)
    pre_j, post_j = _transforms("jax")
    pre_t, post_t = _transforms("torch")
    jx = JHGA(fs=1000, nb_electrodes=64, pre_transforms=pre_j,
              post_transforms=post_j)
    tx = HighGammaExtractor(fs=1000, nb_electrodes=64, pre_transforms=pre_t,
                            post_transforms=post_t, device=CPU)
    js, ts = jx.init_state(), tx.init_state()
    jf, tf = [], []
    for k in range(0, 400, 40):
        f_j, js = jx.packet_step(js, jnp.asarray(raw[k:k + 40]))
        f_t, ts = tx.packet_step(ts, _t(raw[k:k + 40]))
        jf.append(np.asarray(f_j))
        tf.append(f_t.numpy())
    w = tx.warmup_frames(40)
    assert w == jx.warmup_frames(40)
    jf[0], tf[0] = jf[0][w:], tf[0][w:]
    got, want = np.concatenate(tf), np.concatenate(jf)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # One offline pass over the whole 400 samples (its own warm-up frames
    # dropped) gives the chunked frames after the first packet's warm-start
    # frame, in both packages.
    f_one, _ = tx.packet_step(tx.init_state(), _t(raw))
    offline = f_one.numpy()[tx.warmup_frames(400):]
    np.testing.assert_allclose(got[1:], offline, atol=1e-4)
    pre_j2, post_j2 = _transforms("jax")
    j_offline = JHGA(fs=1000, nb_electrodes=64, pre_transforms=pre_j2,
                     post_transforms=post_j2).extract_features(raw)
    np.testing.assert_allclose(offline, j_offline, atol=1e-4)
    # The reference-style stateful path (warm-start framer on the host),
    # fed the same packets, gives the same frames.
    tx.reset()
    stateful = np.concatenate([tx.extract_features(raw[k:k + 40])
                               for k in range(0, 400, 40)])
    assert stateful.shape == got.shape
    np.testing.assert_allclose(got, stateful, atol=1e-4)


def test_vad_smoothing_and_segments_match_jax(rng):
    """Host segmenting is copied: identical outputs on a random stream."""
    labels = rng.random(600) < 0.3
    labels[200:320] = True
    data = rng.normal(size=(600, 3)).astype(np.float32)
    js, ts = JSmooth(3, 5), VoiceActivityDetectionSmoothing(3, 5)
    jh, th = JHist(3, 2000, context=20), SpeechSegmentHistory(3, 2000, 20)
    segs_j, segs_t = [], []
    for k in range(0, 600, 4):
        dj, lj = js.insert(data[k:k + 4], labels[k:k + 4])
        dt, lt = ts.insert(data[k:k + 4], labels[k:k + 4])
        np.testing.assert_array_equal(dj, dt)
        np.testing.assert_array_equal(lj, lt)
        segs_j += jh.insert(dj, lj)
        segs_t += th.insert(dt, lt)
    assert len(segs_t) == len(segs_j) >= 1
    for a, b in zip(segs_t, segs_j):
        np.testing.assert_array_equal(a, b)
