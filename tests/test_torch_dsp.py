"""The port's DSP vocoder, feature encoder and the LPC functions they use,
against the JAX package on the CPU.

* ``band_energies``, ``psd_from_bands``, ``cepstrum_from_bands``,
  ``autocorr_from_psd``, ``lpc_from_cepstrum`` on seeded inputs;
* ``LPCFeatureEncoder`` on seeded PCM with voiced and unvoiced stretches,
  streaming == offline, and a correlation tie (lowest lag wins);
* the DSP vocoder's frame-rate part, and ``dsp_synthesize_frames`` with
  the JAX package's own noise injected, over two consecutive calls;
* chunked == single-shot with the port's own noise, bit for bit;
* ``LPCNet`` / ``BatchedLPCNet`` / ``LPCVocoder`` with ``backend="dsp"``
  and ``apps/synthesize.py``'s default backend.

On the CPU the sample loop runs compiled for the host (bit for bit with
the plain version, the kernel's twin: tests/test_torch_dsp_host.py); the
card tests in tests/test_torch_cuda.py hold the kernel against it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.vocoder import dsp as jdsp
from dss_tpu.vocoder import features as jfeat
from dss_tpu.vocoder import lpc as jlpc
from dss_tpu_torch import vocoder as tvoc
from dss_tpu_torch.apps import synthesize
from dss_tpu_torch.utils import audio as taudio
from dss_tpu_torch.vocoder import dsp as tdsp
from dss_tpu_torch.vocoder import features as tfeat
from dss_tpu_torch.vocoder import lpc as tlpc

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("name, make", [
    ("band_energies", lambda r: r.random((5, 161)) * 3.0),
    ("psd_from_bands", lambda r: r.random((5, 18)) * 3.0),
    ("cepstrum_from_bands", lambda r: r.random((5, 18)) * 3.0 + 1e-3),
    ("autocorr_from_psd", lambda r: r.random((5, 161)) * 3.0),
])
def test_lpc_helpers_match_jax(name, make):
    """Each helper of vocoder/lpc.py on five seeded rows, batched in the
    port and row by row in JAX (its ``autocorr_from_psd`` takes one frame),
    rtol 1e-5 / atol 1e-5 (f32 products and an inverse FFT in another
    order)."""
    x = make(np.random.default_rng(0)).astype(np.float32)
    want = np.stack([np.asarray(getattr(jlpc, name)(jnp.asarray(row)))
                     for row in x])
    got = getattr(tlpc, name)(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lpc_from_cepstrum_matches_jax():
    """Cepstrum -> LPC taps and residual energy, frame by frame in JAX and
    batched in the port: taps atol 1e-4, residual rtol 1e-4."""
    rng = np.random.default_rng(1)
    ceps = (rng.normal(size=(6, 18)) * 0.3).astype(np.float32)
    ceps[:, 0] -= 2.0
    a_t, e_t = tlpc.lpc_from_cepstrum(_t(ceps))
    for k in range(len(ceps)):
        a_j, e_j = jlpc.lpc_from_cepstrum(jnp.asarray(ceps[k]))
        np.testing.assert_allclose(a_t[k].numpy(), np.asarray(a_j),
                                   atol=1e-4)
        np.testing.assert_allclose(float(e_t[k]), float(e_j), rtol=1e-4)


def _voiced_pcm(seconds=1.0, seed=0):
    """int16 PCM at 16 kHz: a gliding two-harmonic tone (f0 80-160 Hz) with
    a little noise, and a noise-only stretch in the middle."""
    fs = 16000
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    f0 = 120.0 + 40.0 * np.sin(2 * np.pi * 1.5 * t)
    ph = 2 * np.pi * np.cumsum(f0) / fs
    sig = 0.3 * np.sin(ph) + 0.15 * np.sin(2 * ph) \
        + 0.02 * rng.normal(size=len(t))
    n = len(t)
    sig[int(0.4 * n):int(0.55 * n)] = 0.05 * rng.normal(
        size=int(0.55 * n) - int(0.4 * n))
    return (sig * 32767).astype(np.int16)


def test_encoder_matches_jax_on_voiced_pcm():
    """LPCFeatureEncoder on a second of voiced and unvoiced PCM: cepstra
    atol 1e-4 (f32 FFT, log10 and DCT), the pitch period feature equal to
    1e-6 (the same lag on every frame) and the correlation feature atol
    1e-5."""
    pcm = _voiced_pcm()
    want = jfeat.LPCFeatureEncoder().compute_LPC_features(pcm)
    got = tvoc.LPCFeatureEncoder(device="cpu").compute_LPC_features(pcm)
    assert got.shape == want.shape == (100, 20) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, :18], want[:, :18], atol=1e-4)
    np.testing.assert_allclose(got[:, 18], want[:, 18], atol=1e-6)
    np.testing.assert_allclose(got[:, 19], want[:, 19], atol=1e-5)
    period, corr = tfeat.pitch_feature_decode(_t(got[:, 18]),
                                              _t(got[:, 19]))
    assert period.min() >= tfeat.PITCH_MIN and period.max() <= 256
    assert float(corr[:30].mean()) > 0.6  # the voiced head (0.69)


@pytest.mark.parametrize("chunk_frames", [1, 4, 7])
def test_encoder_streaming_equals_offline(chunk_frames):
    """Chunks of whole frames through one encoder equal one pass (the
    carried pre-emphasis and history); atol 1e-5 (batched FFTs and products
    over another number of frames); float input in [-1, 1] equals int16
    input / 32768."""
    pcm = _voiced_pcm(0.3, seed=2)
    off = tvoc.LPCFeatureEncoder(device="cpu").compute_LPC_features(pcm)
    enc = tvoc.LPCFeatureEncoder(device="cpu")
    step = chunk_frames * 160
    chunks = [enc.compute_LPC_features(pcm[i:i + step])
              for i in range(0, len(pcm), step)]
    np.testing.assert_allclose(np.concatenate(chunks), off, atol=1e-5)
    enc.reset_encoder()
    as_float = enc.compute_LPC_features(pcm.astype(np.float32) / 32768.0)
    np.testing.assert_array_equal(as_float, off)
    assert enc.compute_LPC_features(pcm[:100]).shape == (0, 20)


def test_encoder_pitch_tie_takes_the_lowest_lag():
    """An exactly periodic signal (period 40 samples) makes the windows 40,
    80, ..., 240 samples back identical to the analysis window, so their
    correlations tie exactly.  ``jnp.argmax`` takes the lowest index, and
    so does ``torch.argmax`` (on the CPU and the card): both encoders give
    period 40 (feature 18 = -1.2), not a multiple of it."""
    rng = np.random.default_rng(3)
    pattern = rng.integers(-12000, 12000, 40).astype(np.int16)
    pcm = np.tile(pattern, 160 * 12 // 40)
    x = pcm.astype(np.float64)
    late = x[-320:]
    for lag in range(40, 257, 40):  # the tie, in the raw signal
        assert np.array_equal(x[-320 - lag:len(x) - lag], late)
    got = tvoc.LPCFeatureEncoder(device="cpu").compute_LPC_features(pcm)
    want = jfeat.LPCFeatureEncoder().compute_LPC_features(pcm)
    # Frames whose context lies wholly in the signal (after 3.6 frames of
    # zero history).
    np.testing.assert_allclose(got[5:, 18], -1.2, atol=1e-6)
    np.testing.assert_allclose(want[5:, 18], -1.2, atol=1e-6)
    tie = torch.tensor([0.5, 0.9, 0.9, 0.1, 0.9])
    assert int(torch.argmax(tie)) == int(jnp.argmax(jnp.asarray(tie))) == 1


def _features(frames, seed):
    """Seeded vocoder features: voiced (corr 0.5-1) and unvoiced frames,
    periods spanning 32-256 samples."""
    rng = np.random.default_rng(seed)
    feats = (rng.normal(size=(frames, 20)) * 0.3).astype(np.float32)
    feats[:, 0] -= 2.0
    feats[:, 18] = rng.uniform(-1.36, 3.12, size=frames)
    feats[:, 19] = np.where(np.arange(frames) % 20 < 12,
                            rng.uniform(0.0, 0.5, frames),
                            rng.uniform(-0.5, -0.2, frames))
    feats[:2, 18] = (-1.36, 3.12)  # periods 32 and 256
    return feats


def _jax_noise(seed, frames):
    """The JAX vocoder's noise for its first ``frames`` frames from
    PRNGKey(seed): per frame ``rng, k = split(rng); normal(k, (160,))``."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(frames):
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(k, (160,), jnp.float32)))
    return np.stack(out)


def test_frame_parameters_match_jax():
    """The frame-rate part, batched over frames: period and voicing exact,
    LPC taps atol 1e-4, gain and voicing mix rtol 1e-4, against JAX's
    per-frame pitch decode, cepstrum -> bands -> Levinson."""
    feats = _features(40, 4)
    lpc, gain, v_mix, voiced, period = tdsp.frame_parameters(_t(feats))
    per_j, corr_j = jfeat.pitch_feature_decode(jnp.asarray(feats[:, 18]),
                                               jnp.asarray(feats[:, 19]))
    np.testing.assert_array_equal(period.numpy(),
                                  np.asarray(per_j).astype(np.int32))
    np.testing.assert_array_equal(voiced.numpy(), np.asarray(corr_j) > 0.3)
    assert voiced.any() and not voiced.all()
    assert period.min() == 32 and period.max() == 256
    np.testing.assert_allclose(
        v_mix.numpy(), np.clip((np.asarray(corr_j) - 0.3) / 0.5, 0, 1),
        rtol=1e-4, atol=1e-7)
    for k in range(len(feats)):
        a_j, e_j = jlpc.lpc_from_cepstrum(jnp.asarray(feats[k, :18]))
        np.testing.assert_allclose(lpc[k].numpy(), np.asarray(a_j), atol=1e-4)
        g_j = np.sqrt(max(float(e_j), 1e-12) / 320 * 2.0)
        np.testing.assert_allclose(float(gain[k]), g_j, rtol=1e-4)


@pytest.mark.parametrize("seed, split", [(3, 35), (8, 21)])
def test_dsp_synthesize_frames_matches_jax_with_jax_noise(seed, split):
    """65 frames in two consecutive calls (split after ``split``), the JAX
    vocoder's noise injected into the port's: float PCM atol 1e-5 and int16
    within 1 LSB (the all-pole filter feeds f32 rounding differences of the
    taps back), pitch phase exact after each call, sig_mem and the
    de-emphasis memory atol 1e-5."""
    T = 65
    feats = _features(T, seed)
    noise = _jax_noise(seed, T)
    js = jdsp.dsp_vocoder_init(seed)
    ts = tdsp.dsp_vocoder_init(seed)
    jp, tp = [], []
    for a, b in ((0, split), (split, T)):
        p, js = jdsp.dsp_synthesize_frames(js, jnp.asarray(feats[a:b]))
        jp.append(np.asarray(p))
        p, ts = tdsp.dsp_synthesize_frames(ts, _t(feats[a:b]),
                                           noise=_t(noise[a:b]))
        tp.append(p.numpy())
        assert int(ts.pitch_phase[0]) == int(js.pitch_phase)
    jp, tp = np.concatenate(jp), np.concatenate(tp)
    assert tp.shape == (T * 160,) and np.abs(jp).max() > 0.1
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    to16 = lambda x: np.clip(x * 32767.0, -32768, 32767).astype(  # noqa: E731
        np.int16).astype(np.int32)
    assert np.abs(to16(tp) - to16(jp)).max() <= 1
    np.testing.assert_allclose(ts.sig_mem[0].numpy(), np.asarray(js.sig_mem),
                               atol=1e-5)
    np.testing.assert_allclose(float(ts.deemph_mem[0]), float(js.deemph_mem),
                               atol=1e-5)
    assert ts.frame_ctr == T


@pytest.mark.parametrize("splits", [(1, 29), (15, 15), (7, 11, 12)])
def test_dsp_chunked_equals_single_shot(splits):
    """With the port's own noise (keyed by absolute frame) any chunking of
    30 frames equals one call bit for bit: PCM, sig_mem, pitch phase,
    de-emphasis memory and frame counter."""
    feats = _t(_features(30, 6))
    whole, s_whole = tdsp.dsp_synthesize_frames(tdsp.dsp_vocoder_init(2),
                                                feats)
    st, parts, a = tdsp.dsp_vocoder_init(2), [], 0
    for n in splits:
        p, st = tdsp.dsp_synthesize_frames(st, feats[a:a + n])
        parts.append(p)
        a += n
    assert torch.equal(torch.cat(parts), whole)
    for x, y in zip(st[:3], s_whole[:3]):
        assert torch.equal(x, y)
    assert st.frame_ctr == s_whole.frame_ctr == 30


def test_gaussian_noise_is_keyed_by_stream_and_frame():
    """The port's noise: standard normal (mean within 0.02, std within
    0.02 over 64,000 draws), a frame's values independent of the call that
    draws it, streams seeded seed + i."""
    n = tdsp.gaussian_noise(5, 2, 0, 200, "cpu")
    assert n.shape == (2, 200, 160)
    assert abs(float(n.mean())) < 0.02 and abs(float(n.std()) - 1) < 0.02
    assert torch.equal(tdsp.gaussian_noise(5, 2, 150, 50, "cpu"), n[:, 150:])
    assert torch.equal(tdsp.gaussian_noise(6, 1, 0, 200, "cpu")[0], n[1])
    assert not torch.equal(n[0], n[1])


def test_frame_synthesize_equals_frames():
    """``dsp_frame_synthesize`` frame by frame equals one
    ``dsp_synthesize_frames`` call bit for bit, on one stream and on two."""
    feats = _t(_features(4, 7))
    whole, _ = tdsp.dsp_synthesize_frames(tdsp.dsp_vocoder_init(1), feats)
    st, parts = tdsp.dsp_vocoder_init(1), []
    for f in feats:
        p, st = tdsp.dsp_frame_synthesize(st, f)
        assert p.shape == (160,)
        parts.append(p)
    assert torch.equal(torch.cat(parts), whole)
    two = torch.stack([feats, feats + 0.1])
    p2, _ = tdsp.dsp_frame_synthesize(tdsp.dsp_vocoder_init(1, 2), two[:, 0])
    assert p2.shape == (2, 160)
    assert torch.equal(p2[0], whole[:160])


def test_lpcnet_dsp_backend_equals_lpc_vocoder():
    """LPCNet(backend="dsp") is the DSP vocoder: int16 [T*160], equal bit
    for bit to LPCVocoder with the same seed, one frame at a time or
    many; ``warm`` leaves the state alone; ``reset_decoder`` restarts it;
    weights are ignored, as in the JAX package."""
    feats = _features(12, 9)
    net = tvoc.LPCNet(backend="dsp", weights="unused.npz", seed=4,
                      device="cpu")
    ref = tvoc.LPCVocoder(seed=4, device="cpu")
    net.warm(10)
    a = net.synthesize_frames(feats[:8])
    b = np.concatenate([net.synthesize(f) for f in feats[8:]])
    want = ref.synthesize_frames(feats)
    assert a.dtype == np.int16 and a.shape == (8 * 160,)
    np.testing.assert_array_equal(np.concatenate([a, b]), want)
    net.reset_decoder()
    np.testing.assert_array_equal(net.synthesize_frames(feats), want)


def test_batched_lpcnet_dsp_backend_against_per_stream_vocoders():
    """BatchedLPCNet(batch=3, backend="dsp", seed=2) runs all streams in one
    call of the sample loop; stream i matches LPCVocoder(seed=2 + i), the
    JAX package's per-stream construction, within 1 LSB (the frame-rate
    part's products run over another number of rows), over two calls."""
    feats = np.stack([_features(10, 10 + i) for i in range(3)])
    voc = tvoc.BatchedLPCNet(batch=3, backend="dsp", seed=2, device="cpu")
    out = np.concatenate([voc.synthesize_frames(feats[:, :6]),
                          voc.synthesize_frames(feats[:, 6:])], axis=1)
    assert out.dtype == np.int16 and out.shape == (3, 1600)
    for i in range(3):
        ref = tvoc.LPCVocoder(seed=2 + i, device="cpu")
        want = np.concatenate([ref.synthesize_frames(feats[i, :6]),
                               ref.synthesize_frames(feats[i, 6:])])
        assert np.abs(out[i].astype(np.int32) - want).max() <= 1
    voc.reset()
    assert voc.state.frame_ctr == 0
    with pytest.raises(ValueError):
        voc.synthesize_frames(feats[:2])


def test_synthesize_app_defaults_to_dsp(tmp_path):
    """apps/synthesize.py with no --backend vocodes with the DSP vocoder,
    as the JAX CLI does: a 16 kHz int16 wav equal to LPCNet(backend="dsp")
    on the same features."""
    feats = _features(5, 11)
    src, out = str(tmp_path / "f.npy"), str(tmp_path / "o.wav")
    np.save(src, feats)
    synthesize.main([src, out, "--device", "cpu"])
    fs, pcm = taudio.read_wav(out)
    want = tvoc.LPCNet(backend="dsp", device="cpu").synthesize_frames(feats)
    assert fs == 16000 and pcm.dtype == np.int16
    np.testing.assert_array_equal(pcm, want)
