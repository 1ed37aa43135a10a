"""The port's replication pipeline (``dss_tpu_torch/apps/replicate.py``,
the counterpart of replicate.sh) on the CPU.

Stages 1-6 run twice on one small non-speech tree of
tools/make_replicate_dataset.py (its four keyword days of one trial each,
their normalization days, the settings INI), one epoch each: once with
h5py and matplotlib, and once with both hidden, as on the card machine.
Each stage must write the files replicate.sh's stage writes; without
h5py the corpus goes from stage 2 to the trainers in memory (and trains
the same models), without matplotlib the figures' arrays are saved and no
figure is claimed, and starting at stage 3 or 4 without h5py raises an
ImportError that names h5py.  The surrogate count is cut to 20 a day.

Stages 7 and 8 (the amplifier and the live decoder over ZMQ) are covered
here only as far as the amplifier's gate; the whole loop runs in
tests/test_torch_end_to_end.py and on the card in chip_smoke.py's phase
"replicate".  Nothing here starts a process."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dss_tpu_torch.apps import replicate
from dss_tpu_torch.apps import development_amplifier
from dss_tpu_torch.eval import contamination
from dss_tpu_torch.models.torch_port import load_checkpoint
from dss_tpu_torch.utils import hdf

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
torch.set_num_threads(1)

import make_replicate_dataset as mrd  # noqa: E402

DAYS = mrd.DAYS


def _hide_h5py(mp):
    def missing():
        raise ImportError("dss_tpu_torch.utils.hdf needs h5py (hidden)")
    mp.setattr(hdf, "_h5py", missing)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("replicate_data")
    rng = np.random.default_rng(0)
    for day in DAYS:
        mrd.make_keyword_day(base / "KeywordReading" / day, rng, n_trials=1)
        mrd.make_syllable_day(base / "SyllableRepetition" / day, rng,
                              n_trials=2)
    return base


def _env(tree, temp, stage=1, stop_stage=6):
    ini = temp.parent / f"{temp.name}.ini"
    ini.write_text(mrd.SETTINGS_TEMPLATE.format(
        base=tree.resolve(), temp=temp.resolve(), online_day=mrd.ONLINE_DAY,
        vocoder="dsp"))
    return dict(DATA_DIR=str(tree / "KeywordReading"),
                NORM_DIR=str(tree / "SyllableRepetition"),
                LIVE_DIR=str(tree / "KeywordReading" / "online_sessions"),
                TEMP_DIR=str(temp), SETTINGS=str(ini), stage=str(stage),
                stop_stage=str(stop_stage))


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    """{"h5py": (temp dir, results), "no_h5py": (...)}: stages 1-6 at one
    epoch each, without and with h5py and matplotlib hidden."""
    out = {}
    for name in ("h5py", "no_h5py"):
        temp = tmp_path_factory.mktemp("runs") / name
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(replicate, "VAD_EPOCHS", 1)
            mp.setattr(replicate, "DECODER_EPOCHS", 1)
            mp.setattr(contamination, "NB_SURROGATES", 20)
            # The trainers write TensorBoard summaries only where it
            # imports; importing it here would import TensorFlow.
            mp.setitem(sys.modules, "torch.utils.tensorboard", None)
            if name == "no_h5py":
                _hide_h5py(mp)
                mp.setitem(sys.modules, "matplotlib", None)
            results = replicate.main(["--device", "cpu"],
                                     env=_env(tree, temp))
        out[name] = (temp, results)
    return out


# The files each stage of replicate.sh leaves in TEMP_DIR (the port's
# training state is train_state.pth, the JAX apps' train_state.pkl; the
# two figures only where matplotlib imports; suppl_fig_2.npz is the
# port's: the figure's arrays).
STAGE_FILES = {
    1: [f"contamination/aggregated_by_day/{d}_KeywordReading_Overt.mat"
        for d in DAYS]
    + [f"contamination/timings/{d}_KeywordReading_Overt_timings.mat"
       for d in DAYS]
    + [f"contamination/analysis/{d}_contamination_result.mat" for d in DAYS],
    2: [],
    3: ["nVAD/best_model.pth", "nVAD/train_state.pth", "nVAD/training.log"],
    4: ["decoding_model/best_model.pth", "decoding_model/train_state.pth",
        "decoding_model/training.log"],
    5: [f"sessions/{mrd.ONLINE_DAY}/normalization.npy",
        f"sessions/{mrd.ONLINE_DAY}/log.normalization.txt"],
    6: ["analysis/suppl_fig_2.npz"],
}
HDF_FILES = [f"corpus/{d}/KeywordReading_Overt_R01.hdf" for d in DAYS]
FIGURES = ["analysis/contamination_report.png", "analysis/suppl_fig_2.png"]


@pytest.mark.parametrize("name", ["h5py", "no_h5py"])
@pytest.mark.parametrize("stage", sorted(STAGE_FILES))
def test_each_stage_writes_the_files_of_replicate_sh(runs, name, stage):
    temp, results = runs[name]
    assert sorted(results) == [1, 2, 3, 4, 5, 6]
    assert results[stage]["seconds"] > 0
    for rel in STAGE_FILES[stage]:
        assert (temp / rel).is_file(), rel
    if stage == 2:
        for rel in HDF_FILES:
            assert (temp / rel).is_file() == (name == "h5py"), rel


def test_stage_logs_hold_the_apps_lines(runs):
    temp, _ = runs["h5py"]
    assert "Epoch 0001" in (temp / "nVAD" / "training.log").read_text()
    assert "Epoch 0001" in \
        (temp / "decoding_model" / "training.log").read_text()
    assert "Writing [mean; std]" in (
        temp / "sessions" / mrd.ONLINE_DAY / "log.normalization.txt"
    ).read_text()


def test_without_h5py_the_corpus_stays_in_memory(runs):
    """The same recordings and trials either way (the trainers log the
    same data sets: the .hdf files hold what stage 2 keeps in memory
    without h5py), no .hdf written without h5py, and each trainer's epoch
    finite.  (The trainers meet the files in another order from disk, so
    their losses are not compared bit for bit.)"""
    (t_disk, disk), (t_mem, mem) = runs["h5py"], runs["no_h5py"]
    assert disk[2]["in_memory"] is False and mem[2]["in_memory"] is True
    assert disk[2]["trials"] == mem[2]["trials"] == 4
    assert [Path(p).name for p in disk[2]["recordings"]] == \
        [Path(p).name for p in mem[2]["recordings"]]
    assert not list(t_mem.rglob("*.hdf"))
    for stage, sub in ((3, "nVAD"), (4, "decoding_model")):
        sets = [sorted(line.split("INFO]: ")[1]
                       for line in (t / sub / "training.log").read_text()
                       .splitlines() if "SequentialSpeechTrials" in line)
                for t in (t_disk, t_mem)]
        assert sets[0] == sets[1] and len(sets[0]) >= 1
        for run in (disk, mem):
            (epoch,) = run[stage]["history"]
            assert np.isfinite([epoch["train_loss"], epoch["valid_loss"]]) \
                .all()
    for sub, bidir, head in (("nVAD", False, "classifier"),
                             ("decoding_model", True, "regressor")):
        for t in (t_disk, t_mem):
            load_checkpoint(str(t / sub / "best_model.pth"), 2, bidir, head)


def test_figures_only_where_matplotlib_imports(runs):
    """With matplotlib: both PNGs, and the results name them.  Without:
    neither file, both results None, and the same arrays."""
    (t_with, with_mpl), (t_without, without) = runs["h5py"], runs["no_h5py"]
    for rel in FIGURES:
        assert (t_with / rel).is_file() and not (t_without / rel).exists()
    assert with_mpl[1]["figure"] == t_with / FIGURES[0]
    assert with_mpl[6]["figure"] == t_with / FIGURES[1]
    assert without[1]["figure"] is None and without[6]["figure"] is None
    a = np.load(t_with / "analysis" / "suppl_fig_2.npz")
    b = np.load(t_without / "analysis" / "suppl_fig_2.npz")
    for k in ("chan_specs", "norm_stats", "onsets"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["chan_specs"].shape == (128, 51, 200)


def test_stage_5_statistics_match_the_normalization_day(runs):
    temp, results = runs["h5py"]
    stats = np.load(temp / "sessions" / mrd.ONLINE_DAY / "normalization.npy")
    assert stats.shape == (2, 128) == tuple(results[5]["shape"])
    assert np.all(np.isfinite(stats)) and np.all(stats[1] > 0)


@pytest.mark.parametrize("stage", [3, 4])
def test_stages_3_and_4_without_h5py_raise_naming_it(tree, tmp_path,
                                                     monkeypatch, stage):
    """Started at stage 3 or 4 without h5py there is no corpus to read:
    an ImportError that names h5py, before any training."""
    _hide_h5py(monkeypatch)
    with pytest.raises(ImportError, match="h5py"):
        replicate.main(["--device", "cpu"],
                       env=_env(tree, tmp_path / "t", stage, stage))
    assert not (tmp_path / "t" / "nVAD").exists()
    assert not (tmp_path / "t" / "decoding_model").exists()


def test_the_configuration_is_replicate_sh(tmp_path):
    """replicate.sh's defaults (days, epochs, replay, stages, waits) and
    its environment variables."""
    cfg = replicate.ReplicateConfig.from_env({})
    assert (replicate.TEST_DAY, replicate.VAL_DAY) == \
        ("2022_11_03", "2022_11_04")
    assert (replicate.VAD_EPOCHS, replicate.DECODER_EPOCHS) == (8, 20)
    assert replicate.REPLAY_SECONDS == 60
    assert (cfg.stage, cfg.stop_stage, cfg.fig_day) == (1, 8, "2022_09_22")
    assert (cfg.amp_start_delay, cfg.amp_max_wait) == (0.0, 900.0)
    assert cfg.settings == REPO / "config" / "debug_settings.ini"
    assert cfg.data_dir == Path("/data/KeywordReading")
    env = dict(DATA_DIR="d", NORM_DIR="n", LIVE_DIR="l", TEMP_DIR="t",
               SETTINGS=str(tmp_path / "s.ini"), stage="3", stop_stage="5",
               FIG_DAY="2022_11_02", AMP_START_DELAY="1.5",
               AMP_MAX_WAIT="30")
    cfg = replicate.ReplicateConfig.from_env(env, device="cpu")
    assert (cfg.data_dir, cfg.norm_dir, cfg.live_dir, cfg.temp_dir) == \
        (Path("d"), Path("n"), Path("l"), Path("t"))
    assert cfg.settings == tmp_path / "s.ini"
    assert (cfg.stage, cfg.stop_stage, cfg.fig_day) == (3, 5, "2022_11_02")
    assert (cfg.amp_start_delay, cfg.amp_max_wait, cfg.device) == \
        (1.5, 30.0, "cpu")


def test_the_amplifier_waits_for_starting_sources(tmp_path, monkeypatch):
    """Stage 7's gate: the amplifier streams once the run log says
    "starting sources", at once without a log to wait for, and after
    AMP_MAX_WAIT when the line never comes."""
    calls = []
    monkeypatch.setattr(development_amplifier, "main",
                        lambda argv: calls.append(list(argv)))
    log = tmp_path / "log.run.txt"
    log.write_text("... System initialized (5 units) — starting sources.\n")
    replicate.gated_amplifier(str(log), 0.0, 60.0, ["a.mat", "--port", "1"])
    replicate.gated_amplifier(None, 0.0, 60.0, ["b.mat"])
    replicate.gated_amplifier(str(tmp_path / "never.txt"), 0.0, 2.0,
                              ["c.mat"])
    assert calls == [["a.mat", "--port", "1"], ["b.mat"], ["c.mat"]]
