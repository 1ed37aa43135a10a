"""Corpus preparation on the port against the JAX package, on the CPU:
the recording parsers, the day splits, bad-channel patching, the energy
VAD and mel filterbank, the per-recording pipeline, the z-scores, the HDF
corpus and ``baseline_offline``'s statistics.  Both run on the same
synthetic days (tests/torch_days.py; the middle day flags bad and
contaminated channels, so the patching post-transform runs).

Tolerances: arrays the JAX package computes in numpy (trial ids, VAD
labels, spans, splits, mel matrices) must be equal; the high-gamma
features carry the front end's stated atol 1e-4 (tests/
test_torch_filter_log_power.py: f32 cascades in two frameworks), the
z-scored ones 1e-4 / (smallest channel std) of their day; the LPC targets
the encoder's atol 1e-4 on the cepstra and 1e-5 on the pitch features
(tests/test_torch_dsp.py)."""

import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (tests/conftest.py keeps it on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.ops.car import BadChannelCorrection as JBadChannelCorrection
from dss_tpu.ops.mel import EnergyBasedVad as JEnergyBasedVad
from dss_tpu.ops.mel import MelFilterBank as JMelFilterBank
from dss_tpu.utils import bci2000 as jbci
from dss_tpu.utils.cv import LeaveOneDayOut as JLeaveOneDayOut
from dss_tpu.utils.hdf import load_hdf as jload_hdf
from dss_tpu_torch.ops.car import BadChannelCorrection
from dss_tpu_torch.ops.mel import EnergyBasedVad, MelFilterBank, hz_to_mel, \
    mel_to_hz
from dss_tpu_torch.utils import bci2000 as tbci
from dss_tpu_torch.utils.channels import default_layout, motor_grid, \
    speech_grid
from dss_tpu_torch.utils.cv import LeaveOneDayOut
from dss_tpu_torch.utils.hdf import load_hdf

from torch_days import DAYS, make_corpus_days

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "apps"))
torch.set_num_threads(1)

FEATURE_ATOL = 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The same days prepared by both packages' apps (JAX: HDF under
    ``jax``; the port: HDF under ``torch`` and the dicts it returned).
    Neither draws its per-trial VAD plots here: nothing compares them, and
    the port's are drawn in tests/test_torch_train_apps.py."""
    import prepare_corpus as jpc

    from dss_tpu_torch.apps import prepare_corpus as tpc

    base = tmp_path_factory.mktemp("torch_corpus")
    data_dir, norm_dir = make_corpus_days(base, n_trials=2,
                                          contaminated_day=DAYS[1])
    with pytest.MonkeyPatch.context() as mp:
        for pipeline in (jpc.FeatureExtractionPipeline,
                         tpc.FeatureExtractionPipeline):
            mp.setattr(pipeline, "_plot_vad", lambda *a, **kw: None)
        jpc.main(out_base_path=base / "jax", norm_dir=norm_dir,
                 folders=[data_dir])
        dicts = tpc.main(out_base_path=base / "torch", norm_dir=norm_dir,
                         folders=[data_dir], device="cpu")
    return base, data_dir, norm_dir, dicts


def _mats(base):
    return sorted(base.rglob("*.mat"))


def test_bci2000_recordings_match_jax(corpus):
    """Trial and stimulus spans (with and without a minimum length), bad
    and contaminated channels, signals, stimuli and codes: equal."""
    base = corpus[0]
    for mat in _mats(base):
        j, t = jbci.BCI2000MatFile(str(mat)), tbci.BCI2000MatFile(str(mat))
        assert t.fs == j.fs
        assert t.trial_indices() == j.trial_indices()
        assert t.trial_indices(2.5) == j.trial_indices(2.5)
        assert t.stimuli_indices() == j.stimuli_indices()
        assert t.bad_channels() == j.bad_channels()
        assert t.contaminated_channels() == j.contaminated_channels()
        assert t.ordered_stimulus_codes() == j.ordered_stimulus_codes()
        np.testing.assert_array_equal(t.signals(), j.signals())
        assert tbci.ExperimentMapping.extract_stimuli_values(t.mat) == \
            jbci.ExperimentMapping.extract_stimuli_values(j.mat)
    flagged = tbci.BCI2000MatFile(
        str(base / "KeywordReading" / DAYS[1] / "KeywordReading_Overt_R01.mat"))
    assert flagged.bad_channels() == [19, 70]
    assert flagged.contaminated_channels() == [38, 100]


@pytest.mark.parametrize("kind", ["SyllableRepetition", "KeywordReading"])
def test_experiment_parsers_match_jax(kind):
    """The parsers on a seeded stimulus-code vector: change points, trial
    and stimulus spans, baseline windows and the run's span equal."""
    rng = np.random.default_rng(3)
    code = np.zeros(4000, np.int16)
    for k, start in enumerate(range(200, 3600, 400)):
        code[start:start + int(rng.integers(100, 250))] = 1 + k % 3
    stimuli = ["a", "b", "c"]
    j = getattr(jbci, kind)(code, stimuli)
    t = getattr(tbci, kind)(code, stimuli)
    np.testing.assert_array_equal(tbci.code_change_points(code),
                                  jbci.code_change_points(code))
    assert t.get_trial_indices() == j.get_trial_indices()
    assert t.get_stimuli_indices() == j.get_stimuli_indices()
    assert t.get_webfm_baseline_windows(1000) == \
        j.get_webfm_baseline_windows(1000)
    assert t.get_experiment_run_indices() == j.get_experiment_run_indices()
    assert repr(t) == repr(j)
    assert tbci.ExperimentMapping.get_experiment_class(f"x_{kind}_R01.mat") \
        .__name__ == kind


@pytest.mark.parametrize("start_with_day", [None, "2022_11_03"])
def test_leave_one_day_out_matches_jax(start_with_day):
    days = ["2022_11_04", "2022_11_02", "2022_11_03", "2022_11_01"]
    got = list(LeaveOneDayOut().split(days, start_with_day=start_with_day))
    want = list(JLeaveOneDayOut().split(days, start_with_day=start_with_day))
    assert got == want
    assert LeaveOneDayOut().get_n_splits(days) == 4
    with pytest.raises(ValueError):
        next(LeaveOneDayOut().split(days, start_with_day="2020_01_01"))


@pytest.mark.parametrize("bad", [[19], [19, 70, 38], [1, 64, 65, 128, 20]])
def test_bad_channel_correction_matches_jax(rng, bad):
    """Each bad channel becomes the mean of its good 8-neighbourhood
    (corners and edges included); atol 1e-6 (f32 means of up to 8 values
    in another order)."""
    grids, layout = [speech_grid(), motor_grid()], default_layout()
    x = rng.normal(size=(2, 50, 128)).astype(np.float32)
    j = JBadChannelCorrection(bad, grids, layout)
    t = BadChannelCorrection(bad, grids, layout)
    assert repr(t) == repr(j) and len(t) == len(j) == len(bad)
    got = t(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(got, j(x), atol=1e-6)
    untouched = np.setdiff1d(np.arange(128), np.asarray(bad) - 1)
    np.testing.assert_array_equal(got[..., untouched], x[..., untouched])


def test_energy_vad_and_mel_filterbank_match_jax(corpus, tmp_path):
    """The energy VAD's labels, MFCCs and .lab text, and the mel
    filterbank's matrices and log-mel round trip: equal (the same numpy
    arithmetic)."""
    from scipy.io import wavfile
    _, audio = wavfile.read(corpus[1] / DAYS[0] / "KeywordReading_Overt_R01.wav")
    audio = audio[:48000]
    j, t = JEnergyBasedVad(), EnergyBasedVad()
    labels = t.from_wav(audio)
    np.testing.assert_array_equal(labels, j.from_wav(audio))
    np.testing.assert_array_equal(t.mfccs, j.mfccs)
    assert labels.any() and not labels.all()
    t.convert_vad_to_lab(str(tmp_path / "t.lab"), labels)
    j.convert_vad_to_lab(str(tmp_path / "j.lab"), labels)
    assert (tmp_path / "t.lab").read_text() == (tmp_path / "j.lab").read_text()

    assert hz_to_mel(1000.0) == pytest.approx(1000.0, abs=0.5)
    np.testing.assert_allclose(mel_to_hz(hz_to_mel(4000.0)), 4000.0)
    mt, mj = MelFilterBank(401, 40, 16000), JMelFilterBank(401, 40, 16000)
    np.testing.assert_array_equal(mt.melMatrix, mj.melMatrix)
    np.testing.assert_array_equal(mt.melInvMatrix, mj.melInvMatrix)
    spec = np.abs(np.random.default_rng(0).normal(size=(20, 401)))
    np.testing.assert_array_equal(mt.toLogMels(spec), mj.toLogMels(spec))
    np.testing.assert_array_equal(mt.fromLogMels(mt.toLogMels(spec)),
                                  mj.fromLogMels(mj.toLogMels(spec)))


def test_pipeline_matches_jax(corpus):
    """The recording that flags bad and contaminated channels through both
    pipelines (so with the patching post-transform; the other days are
    compared through their HDF files): features atol 1e-4, LPC targets at
    the encoder's tolerances, VAD labels and trial ids equal; the port
    draws one VAD plot per trial."""
    day = DAYS[1]
    import prepare_corpus as jpc

    from dss_tpu_torch.apps import prepare_corpus as tpc

    base, data_dir = corpus[:2]
    mat = data_dir / day / "KeywordReading_Overt_R01.mat"
    kw = dict(mat_filename=mat, wav_filename=mat.with_suffix(".wav"),
              min_trial_length=2.5, vad_plot_dir=str(base / "plots"))
    j = jpc.FeatureExtractionPipeline(**kw)
    t = tpc.FeatureExtractionPipeline(**dict(kw, vad_plot_dir=str(
        base / "torch_plots")), device="cpu")
    feats = t.get_features()
    assert feats.shape == (600, 128) and feats.dtype == np.float32
    np.testing.assert_allclose(feats, j.get_features(), atol=FEATURE_ATOL)
    lpc, want = t.get_lpc_coefficients(), j.get_lpc_coefficients()
    assert lpc.shape == want.shape == (600, 20)
    np.testing.assert_allclose(lpc[:, :18], want[:, :18], atol=1e-4)
    np.testing.assert_allclose(lpc[:, 18:], want[:, 18:], atol=1e-5)
    np.testing.assert_array_equal(t.get_vad_labels(), j.get_vad_labels())
    assert sorted(p.name for p in (base / "torch_plots" / day).iterdir()) \
        == ["KeywordReading_Overt_R01_001.png",
            "KeywordReading_Overt_R01_002.png"]
    ids = t.get_trial_ids()
    np.testing.assert_array_equal(ids, j.get_trial_ids())
    assert ids.dtype == np.int16
    assert t.accumulative_audio_duration() == j.accumulative_audio_duration()
    assert tpc.get_feature_extractor(t.mat, device="cpu").post_transform \
        is not None


def test_zscores_match_jax(corpus):
    """Per-day normalization statistics: mean and std atol 1e-4."""
    import prepare_corpus as jpc

    from dss_tpu_torch.apps import prepare_corpus as tpc

    norm_dir = corpus[2]
    recs = {p.parent.name: p for p in norm_dir.glob("**/*.mat")}
    got = tpc.ZScoresFromSyllableRepetitions(recs, device="cpu")
    want = jpc.ZScoresFromSyllableRepetitions(recs)
    assert sorted(got) == sorted(want) == sorted(DAYS)
    for day in DAYS:
        for a, b in zip(got[day], want[day]):
            assert a.shape == (128,)
            np.testing.assert_allclose(a, b, atol=FEATURE_ATOL)


def test_hdf_corpus_matches_jax(corpus):
    """The port's HDF files hold the same datasets as the JAX package's,
    key for key, with equal dtypes and shapes: trial ids and VAD labels
    equal, LPC targets at the encoder's tolerances, z-scored features at
    1e-4 / (the day's smallest channel std); main returns what it wrote."""
    import prepare_corpus as jpc

    base, _, norm_dir, dicts = corpus
    recs = {p.parent.name: p for p in norm_dir.glob("**/*.mat")}
    stds = {day: s for day, (_, s) in
            jpc.ZScoresFromSyllableRepetitions(recs).items()}
    files = sorted((base / "torch").rglob("*.hdf"))
    assert [f.relative_to(base / "torch") for f in files] == \
        [f.relative_to(base / "jax") for f in sorted((base / "jax").rglob("*.hdf"))]
    assert sorted(dicts) == [f.as_posix() for f in files]
    for f in files:
        got = load_hdf(str(f))
        want = jload_hdf(str(base / "jax" / f.relative_to(base / "torch")))
        assert sorted(got) == sorted(want) == ["hga_activity", "lpc_coefficients",
                                               "trial_ids", "vad_labels"]
        for key in got:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].shape == want[key].shape, key
            np.testing.assert_array_equal(got[key], dicts[f.as_posix()][key])
        np.testing.assert_array_equal(got["trial_ids"], want["trial_ids"])
        np.testing.assert_array_equal(got["vad_labels"], want["vad_labels"])
        np.testing.assert_allclose(got["lpc_coefficients"][:, :18],
                                   want["lpc_coefficients"][:, :18], atol=1e-4)
        np.testing.assert_allclose(got["lpc_coefficients"][:, 18:],
                                   want["lpc_coefficients"][:, 18:], atol=1e-5)
        atol = FEATURE_ATOL / float(stds[f.parent.name].min())
        np.testing.assert_allclose(got["hga_activity"], want["hga_activity"],
                                   atol=atol)


def test_baseline_offline_matches_jax(corpus, tmp_path):
    """normalization.npy [mean; std] of one SyllableRepetition day: shape
    [2, 128], atol 1e-4."""
    import baseline_offline as japp

    from dss_tpu_torch.apps import baseline_offline as tapp

    norm = corpus[2] / DAYS[1] / "SyllableRepetition_Overt.mat"
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    japp.main(session=str(tmp_path / "j"), norm_file=str(norm))
    stats = tapp.main(session=str(tmp_path / "t"), norm_file=str(norm),
                      device="cpu")
    got = np.load(tmp_path / "t" / "normalization.npy")
    np.testing.assert_array_equal(got, stats)
    assert got.shape == (2, 128) and np.all(got[1] > 0)
    np.testing.assert_allclose(got, np.load(tmp_path / "j" / "normalization.npy"),
                               atol=FEATURE_ATOL)
    ini = tmp_path / "n.ini"
    ini.write_text(f"[Normalization]\nbase_path = {tmp_path}\nsession = s1\n"
                   f"normalization_file = {norm}\n")
    assert tapp.get_paths(str(ini)) == japp.get_paths(str(ini))


NEW_MODULES = [
    "dss_tpu_torch.utils.bci2000", "dss_tpu_torch.utils.cv",
    "dss_tpu_torch.utils.hdf", "dss_tpu_torch.ops.car",
    "dss_tpu_torch.ops.mel", "dss_tpu_torch.apps.prepare_corpus",
    "dss_tpu_torch.apps.baseline_offline", "dss_tpu_torch.train",
    "dss_tpu_torch.train.dataset", "dss_tpu_torch.train.optim",
    "dss_tpu_torch.train.checkpoints", "dss_tpu_torch.train.trainer_vad",
    "dss_tpu_torch.train.trainer_decoder", "dss_tpu_torch.train.synth_queue",
    "dss_tpu_torch.apps.train_unidirectional_vad",
    "dss_tpu_torch.apps.train_bidirectional_model",
    "dss_tpu_torch.eval.quality", "dss_tpu_torch.convert",
]


def test_new_modules_import_without_jax_and_h5py(tmp_path):
    """Every module of the training path imports in a fresh interpreter
    where neither jax nor h5py can be imported, loads nothing of dss_tpu,
    and writing or reading an HDF container there raises an ImportError
    that names h5py."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['h5py'] = None\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'dss_tpu' or k.startswith('dss_tpu.') "
            "for k in sys.modules)\n"
            "from dss_tpu_torch.utils.hdf import load_hdf, save_data_to_hdf\n"
            "for call in (lambda: save_data_to_hdf("
            f"{str(tmp_path / 'x.hdf')!r}, {{}}), lambda: load_hdf('x.hdf')):\n"
            "    try:\n"
            "        call()\n"
            "    except ImportError as e:\n"
            "        assert 'h5py' in str(e), e\n"
            "    else:\n"
            "        raise AssertionError('no ImportError')\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert not (tmp_path / "x.hdf").exists()
