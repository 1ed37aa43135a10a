"""The port's audio-quality metrics (dss_tpu_torch/eval/quality.py)
against the JAX package's, on the CPU, on the same audio.

Tolerances: STOI is the same numpy arithmetic (rtol 1e-12); everything
that goes through the feature encoder inherits its f32 differences between
frameworks (cepstra within 1e-4, tests/test_torch_dsp.py): distances in dB
atol 1e-3, SNRs rtol 1e-4 (near identical signals put the error energy
itself near the encoder's f32 noise: x against its int16 copy is 72 dB),
DTW distances rtol 1e-4, the keyword reports equal in every
prediction and count with margins atol 1e-3.  ``score_roundtrip`` runs the
DSP vocoder with the JAX vocoder's own noise injected into the port's
(the two draw no shared random stream): atol 0.01 dB (int16 samples within
1 LSB feed the encoder again)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.eval import quality as jq
from dss_tpu.vocoder.dsp import LPCVocoder
from dss_tpu_torch.eval import quality as tq
from dss_tpu_torch.vocoder import dsp as tdsp
from dss_tpu_torch.vocoder.lpcnet import LPCNet

torch.set_num_threads(1)
FS = 16000
DB = 1e-3


def _speechlike(seconds=1.0, f0=125.0, seed=0):
    """Pitched harmonic stack with a slow spectral-envelope sweep."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * FS)) / FS
    sig = np.zeros_like(t)
    for k in range(1, 24):
        f = k * f0
        if f > 6000:
            break
        env = np.exp(-f / (1500.0 + 1000.0 * np.sin(2 * np.pi * 1.3 * t)))
        sig += env * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    sig *= 0.25 / np.max(np.abs(sig))
    return sig.astype(np.float32)


def _word(f0, formants, seconds=0.45, seed=0):
    """Synthetic 'keyword': pitched stack under a two-formant envelope."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * FS)) / FS
    sig = np.zeros_like(t)
    for k in range(1, 60):
        f = k * f0
        if f > 7000:
            break
        env = sum(np.exp(-0.5 * ((f - fm) / 250.0) ** 2)
                  for fm in formants) + 0.01
        sig += env * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    sig *= 0.25 / np.max(np.abs(sig))
    return sig.astype(np.float32)


@pytest.fixture(scope="module")
def audio():
    x = _speechlike()
    rng = np.random.default_rng(1)
    return {"x": x,
            "slight": x + 0.002 * rng.normal(size=x.shape).astype(np.float32),
            "noise": (0.25 * rng.normal(size=x.shape)).astype(np.float32),
            "int16": (x * 32767).astype(np.int16)}


@pytest.mark.parametrize("other", ["x", "slight", "noise", "int16"])
def test_cepstral_metrics_match_jax(audio, other):
    """cepstral_distance, band_level_snr and score (dB atol 1e-3, the
    frame count equal), int16 and float input alike."""
    x, y = audio["x"], audio[other]
    for skip in (2, 0):
        got = tq.score(x, y, skip, device="cpu")
        want = jq.score(x, y, skip)
        assert got.num_frames == want.num_frames == 100 - skip
        assert got.cepstral_distance_db == pytest.approx(
            want.cepstral_distance_db, abs=DB)
        assert got.band_level_snr_db == pytest.approx(
            want.band_level_snr_db, rel=1e-4)
    assert tq.cepstral_distance(x, y, device="cpu") == pytest.approx(
        jq.cepstral_distance(x, y), abs=DB)
    assert tq.band_level_snr(x, y, device="cpu") == pytest.approx(
        jq.band_level_snr(x, y), rel=1e-4)
    if other == "x":
        assert tq.cepstral_distance(x, y, device="cpu") < 1e-4
    with pytest.raises(ValueError):
        tq.cepstral_distance(x[:320], x[:320], device="cpu")


def test_stoi_matches_jax(audio):
    x = audio["x"]
    for other in ("x", "slight", "noise", "int16"):
        assert tq.stoi(x, audio[other]) == pytest.approx(
            jq.stoi(x, audio[other]), rel=1e-12)
    assert tq.stoi(x, x) > 0.99 and tq.stoi(x, audio["noise"]) < 0.35
    with pytest.raises(ValueError):
        tq.stoi(x[:3000], x[:3000])


def test_dtw_and_keyword_reports_match_jax():
    """DTW distances rtol 1e-4; the keyword report's accuracy, predictions
    and confusion equal, margins atol 1e-3; an unknown word is an error."""
    words = {"left": _word(110.0, (300, 2200), seed=1),
             "right": _word(130.0, (700, 1100), seed=2),
             "up": _word(150.0, (450, 3400), seed=3)}
    a = words["left"]
    stretched = np.interp(np.linspace(0, len(a) - 1, int(len(a) * 1.15)),
                          np.arange(len(a)), a).astype(np.float32)
    for b in (stretched, words["up"]):
        assert tq.dtw_cepstral_distance(a, b, device="cpu") == pytest.approx(
            jq.dtw_cepstral_distance(a, b), rel=1e-4)
    rng = np.random.default_rng(7)
    resyn = {w: [(v + 0.004 * rng.normal(size=v.shape)).astype(np.float32),
                 (0.2 * rng.normal(size=v.shape)).astype(np.float32)]
             for w, v in words.items()}
    resyn["mystery"] = _word(170.0, (500, 2600), seed=4)
    got = tq.keyword_id_report(words, resyn, device="cpu")
    want = jq.keyword_id_report(words, resyn)
    assert got["accuracy"] == want["accuracy"]
    assert got["confusion"] == want["confusion"]
    assert len(got["margins"]) == len(want["margins"]) == 7
    for g, w in zip(got["margins"], want["margins"]):
        assert g.keys() == w.keys()
        assert (g["word"], g["predicted"]) == (w["word"], w["predicted"])
        for key in ("own_d", "best_other_d", "margin"):
            if key in g and not np.isnan(g[key]):
                assert g[key] == pytest.approx(w[key], abs=DB)
    assert tq.keyword_id_accuracy(words, resyn, device="cpu") == \
        jq.keyword_id_accuracy(words, resyn)
    with pytest.raises(ValueError):
        tq.keyword_id_report(words, {}, device="cpu")


class _InjectedDsp:
    """The port's DSP vocoder with the JAX vocoder's noise injected: per
    frame ``rng, k = split(rng); normal(k, (160,))`` from PRNGKey(seed),
    as dss_tpu/vocoder/dsp.py draws it."""

    def __init__(self, seed=0):
        self._seed = seed

    def synthesize_frames(self, feats):
        rng, noise = jax.random.PRNGKey(self._seed), []
        for _ in range(len(feats)):
            rng, k = jax.random.split(rng)
            noise.append(np.asarray(jax.random.normal(k, (160,),
                                                      jnp.float32)))
        pcm, _ = tdsp.dsp_synthesize_frames(
            tdsp.dsp_vocoder_init(self._seed),
            torch.as_tensor(np.asarray(feats, np.float32)),
            noise=torch.as_tensor(np.stack(noise)))
        return tdsp.to_int16(pcm)


def test_score_roundtrip_through_dsp_matches_jax(audio):
    """score_roundtrip with the DSP vocoder: on the JAX noise, the port's
    report equals JAX's within 0.01 dB; with the port's own noise the
    JAX package's gate holds (CD < 22 dB, under half of silence's)."""
    x = audio["x"]
    got = tq.score_roundtrip(x, _InjectedDsp(), device="cpu")
    want = jq.score_roundtrip(x, LPCVocoder())
    assert got.num_frames == want.num_frames >= 90
    assert got.cepstral_distance_db == pytest.approx(
        want.cepstral_distance_db, abs=0.01)
    assert got.band_level_snr_db == pytest.approx(want.band_level_snr_db,
                                                  abs=0.01)
    own = tq.score_roundtrip(x, LPCNet(backend="dsp", device="cpu"),
                             device="cpu")
    silence = tq.score(x, np.zeros_like(x), device="cpu").cepstral_distance_db
    assert own.cepstral_distance_db < 22.0
    assert own.cepstral_distance_db < silence / 2
