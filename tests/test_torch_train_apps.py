"""The port's training-path apps end to end on the CPU (the counterparts
of tests/test_apps.py): prepare_corpus -> train the nVAD -> train the
decoder -> baseline_offline on a synthetic three-day corpus, the
checkpoints read by both packages' loaders, resume, the in-memory corpus
path, and the default device refused where there is no card."""


import jax  # noqa: F401  (tests/conftest.py keeps it on the CPU)
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from dss_tpu.models import load_checkpoint as jload_checkpoint
from dss_tpu_torch.apps import baseline_offline, prepare_corpus
from dss_tpu_torch.apps import train_bidirectional_model as dec_app
from dss_tpu_torch.apps import train_unidirectional_vad as vad_app
from dss_tpu_torch.models.torch_port import load_checkpoint
from dss_tpu_torch.utils.hdf import load_hdf

from torch_days import DAYS, make_corpus_days

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three days of two trials each, prepared through the port's app."""
    base = tmp_path_factory.mktemp("torch_apps")
    data_dir, norm_dir = make_corpus_days(base, n_trials=2)
    out_dir = base / "prepared"
    dicts = prepare_corpus.main(out_base_path=out_dir, norm_dir=norm_dir,
                                folders=[data_dir], device="cpu")
    return base, out_dir, dicts


def _vad_cfg(out_dir, tmp_path, batch_size=1):
    return vad_app.TrainingConfiguration(
        nb_hidden_units=16, nb_layer=1, nb_epochs=1, batch_size=batch_size,
        num_workers=0, truncated_sequence_length=50,
        speech_corpus_root=out_dir, out_dir=tmp_path,
        test_day=DAYS[2], valid_day=DAYS[1], device="cpu")


def test_prepare_corpus_output(corpus):
    _, out_dir, dicts = corpus
    files = sorted(out_dir.rglob("*.hdf"))
    assert len(files) == 3 and sorted(dicts) == [f.as_posix() for f in files]
    data = load_hdf(str(files[0]))
    assert set(data) == {"hga_activity", "lpc_coefficients", "vad_labels",
                         "trial_ids"}
    n = len(data["trial_ids"])
    assert data["hga_activity"].shape == (n, 128)
    assert data["lpc_coefficients"].shape == (n, 20)
    assert len(data["vad_labels"]) == n
    assert set(np.abs(np.unique(data["trial_ids"]))) <= {1, 2}
    assert abs(float(data["hga_activity"].mean())) < 1.0


def test_frame_alignment_counts(corpus):
    """Every dataset of a file has one row per frame: per trial
    floor((samples + 40 - 40) / 10) frames, 300 for a 3 s trial."""
    for f in corpus[1].rglob("*.hdf"):
        data = load_hdf(str(f))
        assert {len(v) for v in data.values()} == {600}


def test_train_vad_app_and_resume(corpus, tmp_path):
    """One epoch at B = 1 writes a best model that both packages' loaders
    read and a training state; --resume continues from its epoch."""
    cfg = _vad_cfg(corpus[1], tmp_path)
    vad_app.main(cfg)
    assert (tmp_path / "best_model.pth").exists()
    params = jload_checkpoint(str(tmp_path / "best_model.pth"), 1, False,
                              "classifier")
    assert params["classifier"]["weight"].shape == (2, 16)
    sd = load_checkpoint(str(tmp_path / "best_model.pth"), 1, False,
                         "classifier")
    assert all(torch.isfinite(v).all() for v in sd.values())
    assert (tmp_path / "valid_viz" / "epoch=001").is_dir()

    first = torch.load(tmp_path / "train_state.pth")
    assert first["extra"] == {"epoch": 1}
    cfg.nb_epochs, cfg.resume = 2, True
    vad_app.main(cfg)
    second = torch.load(tmp_path / "train_state.pth")
    assert second["extra"] == {"epoch": 2}
    assert any(not torch.equal(first["model"][k], second["model"][k])
               for k in first["model"])


def test_train_vad_app_batched_from_memory_equals_files(corpus, tmp_path):
    """Batched (padded, masked) TBPTT from the .hdf files and from the
    in-memory corpus ``prepare`` returns give the same checkpoint (same
    torch seed for the dropout masks)."""
    _, out_dir, dicts = corpus
    states = []
    for name, recordings in (("files", None), ("memory", dicts)):
        (tmp_path / name).mkdir()
        torch.manual_seed(0)
        vad_app.main(_vad_cfg(out_dir, tmp_path / name, batch_size=2),
                     recordings=recordings)
        states.append(torch.load(tmp_path / name / "best_model.pth"))
    for k in states[0]:
        torch.testing.assert_close(states[0][k], states[1][k], rtol=0, atol=0)


def test_train_decoder_app(corpus, tmp_path):
    """One epoch: a best model both loaders read, and the per-epoch
    synthesis through the queue (the queue is waited on): every .npy has
    its .wav of frames x 160 samples."""
    cfg = dec_app.TrainingConfiguration(
        nb_hidden_units=12, nb_layer=1, nb_epochs=1, batch_size=1,
        num_workers=0, speech_corpus_root=corpus[1], out_dir=tmp_path,
        test_day=DAYS[2], valid_day=DAYS[1], device="cpu")
    dec_app.main(cfg)
    assert (tmp_path / "best_model.pth").exists()
    params = jload_checkpoint(str(tmp_path / "best_model.pth"), 1, True,
                              "regressor")
    assert params["regressor"]["weight"].shape == (20, 24)
    npys = sorted(tmp_path.rglob("*.npy"))
    assert [p.name for p in npys] == ["orig.npy", "orig_train.npy",
                                      "reco_epoch=001.npy",
                                      "train_epoch=001.npy"]
    for npy in npys:
        frames = np.load(npy)
        assert frames.shape == (600, 20) and np.all(np.isfinite(frames))
        fs, pcm = wavfile.read(npy.with_suffix(".wav"))
        assert fs == 16000 and pcm.dtype == np.int16
        assert len(pcm) == len(frames) * 160 and pcm.any()


def test_baseline_offline_app(corpus, tmp_path):
    session = tmp_path / "session"
    session.mkdir()
    norm_file = corpus[0] / "SyllableRepetition" / DAYS[1] / \
        "SyllableRepetition_Overt.mat"
    baseline_offline.main(session=str(session), norm_file=str(norm_file),
                          device="cpu")
    stats = np.load(session / "normalization.npy")
    assert stats.shape == (2, 128)
    assert np.all(stats[1] > 0)


def test_apps_default_to_the_card(corpus, tmp_path, monkeypatch):
    """Without device="cpu" every app asks for cuda and raises here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, out_dir, _ = corpus
    norm_dir = base / "SyllableRepetition"
    calls = [
        lambda: prepare_corpus.prepare(tmp_path, norm_dir,
                                       [base / "KeywordReading"]),
        lambda: baseline_offline.main(str(tmp_path), str(
            next(norm_dir.rglob("*.mat")))),
        lambda: vad_app.main(vad_app.TrainingConfiguration(
            16, 1, 1, 1, 0, 50, out_dir, tmp_path, DAYS[2], DAYS[1])),
        lambda: dec_app.main(dec_app.TrainingConfiguration(
            12, 1, 1, 1, 0, out_dir, tmp_path, DAYS[2], DAYS[1])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
