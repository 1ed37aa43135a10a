"""The port's contamination analysis (dss_tpu_torch/eval/contamination.py)
against the JAX package's (dss_tpu/eval/contamination.py), on the CPU, on
synthetic days built as tests/test_eval.py builds them: 40 s at 1 kHz, 32
channels, amplitude-modulated noise as audio, and on the contaminated day
one channel that carries the audio.

The numpy stages are copies: equal bit for bit.  The surrogates run in
float32 on both sides (JAX's vmap, the port's batched products), so their
measures agree to rtol 1e-4."""

import numpy as np
import pytest
import torch
from scipy.io import loadmat, savemat

from dss_tpu.eval import contamination as jc
from dss_tpu_torch.eval import contamination as tc

torch.set_num_threads(1)
FS = 1000


def _day(seed, contaminated, seconds=40, channels=32):
    rng = np.random.default_rng(seed)
    T = seconds * FS
    env = (np.sin(2 * np.pi * np.arange(T) / (4 * FS)) > 0).astype(float)
    audio = rng.normal(size=T) * (0.1 + env)
    ecog = rng.normal(size=(T, channels))
    if contaminated:
        ecog[:, 3] += 5.0 * audio
    return ecog, audio


def _write_days(agg):
    agg.mkdir()
    for name, dirty in (("2022_09_22", False), ("2022_09_23", True)):
        ecog, audio = _day(0 if not dirty else 1, dirty)
        savemat(str(agg / f"{name}_KeywordReading_Overt.mat"),
                dict(fs=FS, ecog=ecog, audio=audio))


def test_numpy_stages_equal_jax():
    """Artifact detection (with a burst of artifacts, so the safety margin
    dilates), the band spectrograms and the lagged correlation measure:
    the same arrays and the same float."""
    ecog, audio = _day(2, contaminated=True, seconds=12)
    ecog[5000:5020] += 40.0
    np.testing.assert_array_equal(tc.detect_artifacts(ecog, FS),
                                  jc.detect_artifacts(ecog, FS))
    assert tc.detect_artifacts(ecog, FS).sum() > 1000
    for x in (ecog, audio):
        for got, want in zip(tc.band_spectrogram(x, FS),
                             jc.band_spectrogram(x, FS)):
            np.testing.assert_array_equal(got, want)
    a, _, _ = tc.band_spectrogram(audio, FS)
    b, _, _ = tc.band_spectrogram(ecog, FS)
    got, got_cf = tc.lagged_correlation_measure(a, b, 25)
    want, want_cf = jc.lagged_correlation_measure(a, b, 25)
    assert got == want
    np.testing.assert_array_equal(got_cf, want_cf)


def test_surrogates_match_jax():
    """300 surrogates of the contaminated day on the port's batched torch
    path (device cpu) against JAX's vmap: the same shifts, measures within
    rtol 1e-4; the first four also against the numpy plain version."""
    ecog, audio = _day(3, contaminated=True)
    a_spec, b_spec = tc.day_spectrograms(ecog, audio, FS)
    got = tc.surrogate_measures(a_spec, b_spec, 25, 300, seed=0,
                                device="cpu")
    want = jc.surrogate_measures(a_spec, b_spec, 25, 300, seed=0)
    assert got.shape == (300,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)
    shifts = tc.surrogate_shifts(len(a_spec), 25, 300, seed=0)
    for s, g in zip(shifts[:4], got[:4]):
        m, _ = tc.lagged_correlation_measure(
            np.roll(a_spec, int(s), axis=0), b_spec, 25)
        np.testing.assert_allclose(g, m, rtol=1e-4)


def test_result_mat_layout_matches_jax(tmp_path):
    """analyze_day of both packages on the same day file: the same .mat
    keys, shapes and dtypes, the same dataset measure, surrogates within
    rtol 1e-4."""
    agg = tmp_path / "agg"
    _write_days(agg)
    f = agg / "2022_09_23_KeywordReading_Overt.mat"
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    tc.analyze_day(f, tmp_path / "port", nb_surrogates=64, device="cpu")
    jc.analyze_day(f, tmp_path / "jax", nb_surrogates=64)
    name = "2022_09_23_contamination_result.mat"
    got = loadmat(str(tmp_path / "port" / name))["out"]
    want = loadmat(str(tmp_path / "jax" / name))["out"]
    assert got.dtype.names == want.dtype.names
    for key in want.dtype.names:
        g, w = got[key][0, 0], want[key][0, 0]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=key)


def test_calibration_clean_and_contaminated_days(tmp_path, monkeypatch):
    """The port's CLI over a clean and a contaminated day (500 surrogates
    a day, as tests/test_eval.py uses): the clean day does not trip the
    p < 0.05 criterion, the contaminated one does, with the larger
    measure."""
    agg, out = tmp_path / "agg", tmp_path / "analysis"
    _write_days(agg)
    monkeypatch.setattr(tc, "NB_SURROGATES", 500)
    tc.main(["--agg-path", str(agg), "--out", str(out), "--device", "cpu"])
    clean = loadmat(str(out / "2022_09_22_contamination_result.mat"),
                    simplify_cells=True)["out"]
    dirty = loadmat(str(out / "2022_09_23_contamination_result.mat"),
                    simplify_cells=True)["out"]
    assert clean["criterion_value"] >= 0.05
    assert dirty["criterion_value"] < 0.05
    assert dirty["dataset_measure"] > clean["dataset_measure"]
    assert len(clean["surrogate_measures"]) == 500


def test_an_error_in_the_batched_path_raises(monkeypatch):
    """No fallback: an error inside the batched products propagates, and
    the host loop never runs in its place."""
    ecog, audio = _day(4, contaminated=False, seconds=12)
    a_spec, b_spec = tc.day_spectrograms(ecog, audio, FS)

    def broken(*args, **kw):
        raise RuntimeError("batched product failed")

    def host_loop(*args, **kw):
        raise AssertionError("fell back to the host loop")

    monkeypatch.setattr(torch, "bmm", broken)
    monkeypatch.setattr(tc, "lagged_correlation_measure", host_loop)
    with pytest.raises(RuntimeError, match="batched product failed"):
        tc.surrogate_measures(a_spec, b_spec, 25, 8, device="cpu")


def test_surrogates_default_to_the_card():
    """Like every entry point, the surrogates run on cuda unless asked
    otherwise, and raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    a = np.zeros((200, 21))
    b = np.zeros((200, 2, 21))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.surrogate_measures(a, b, 25, 4)
