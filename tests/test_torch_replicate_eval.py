"""The replication pipeline's evaluation stages on the port against the
JAX scripts, on the CPU, on the same seeded inputs:
``dss_tpu_torch/eval/aggregate_per_day.py`` against
eval/contamination/aggregate_per_day.py, the contamination CLI against
eval/contamination/contamination_analysis.py, and
``dss_tpu_torch/eval/suppl_fig_2.py`` against eval/suppl_fig_2.py.

Tolerances: aggregation and the VAD timings are the same numpy arithmetic
(equal bit for bit).  Supplementary figure 2's arrays: the port's
spectrograms are float64 FFTs in torch, scipy's in numpy, and the baseline
is rounded to float32 on both sides, so the float32 dB values agree to
atol 1e-4 dB.  The contamination results: equal file names and layout, and
measures within rtol 1e-4 (the surrogates are float32 products on both
sides, as tests/test_torch_contamination.py states).

The last test reads the imports of the replication and scoring modules
(and of the port modules they import) from their source: none is jax or
dss_tpu."""

import ast
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import loadmat, savemat

from dss_tpu.eval import contamination as jcore
from dss_tpu_torch.eval import aggregate_per_day as tagg
from dss_tpu_torch.eval import contamination as tcore
from dss_tpu_torch.eval import suppl_fig_2 as tsf2

from torch_days import make_day

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "eval"))
sys.path.insert(0, str(REPO / "eval" / "contamination"))
torch.set_num_threads(1)

import aggregate_per_day as jagg  # noqa: E402
import contamination_analysis as jca  # noqa: E402
import suppl_fig_2 as jsf2  # noqa: E402

DB_ATOL = 1e-4


@pytest.mark.parametrize("labels", [
    [0, 0, 1, 1, 1, 0, 0, 1, 0],      # tests/test_eval.py's case
    [0, 0, 1, 1],                     # ends voiced
    [1, 1, 0, 0],                     # starts voiced
    [1, 1, 1, 1],                     # voiced throughout
    [0, 0, 0, 0],                     # silent throughout
    "random",
])
def test_vad_timings_equal_jax(labels):
    if labels == "random":
        labels = np.random.default_rng(3).random(500) > 0.6
    labels = np.asarray(labels, bool)
    got, want = tagg.vad_timings(labels), jagg.vad_timings(labels)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    """Three keyword days, one of them a contaminated day (channel 46
    excluded), one with two recordings (concatenated)."""
    root = tmp_path_factory.mktemp("keyword_days")
    make_day(root / "2022_10_05", n_trials=2, seed=1)
    make_day(root / "2022_11_03", n_trials=2, seed=2)
    make_day(root / "2022_11_04", n_trials=1, seed=3)
    second = root / "2022_11_04" / "KeywordReading_Overt_R01.mat"
    mat = {k: v for k, v in loadmat(str(second), simplify_cells=True).items()
           if not k.startswith("__")}
    mat["signal"] = mat["signal"][::-1] * 0.5
    savemat(str(root / "2022_11_04" / "KeywordReading_Overt_R02.mat"), mat)
    return root


def test_aggregate_data_equal_jax(corpus_root, tmp_path):
    """Every .mat both packages write: the same file names and the same
    arrays bit for bit (the contaminated day keeps 63 channels)."""
    outs = {}
    for name, mod in (("jax", jagg), ("torch", tagg)):
        agg, timing = tmp_path / name / "agg", tmp_path / name / "timings"
        agg.mkdir(parents=True)
        timing.mkdir()
        mod.aggregate_data(corpus_root, agg, timing)
        outs[name] = {p.relative_to(tmp_path / name): loadmat(str(p))
                      for p in sorted((tmp_path / name).rglob("*.mat"))}
    assert list(outs["torch"]) == list(outs["jax"])
    assert len(outs["torch"]) == 6
    for rel, want in outs["jax"].items():
        got = outs["torch"][rel]
        keys = sorted(k for k in want if not k.startswith("__"))
        assert sorted(k for k in got if not k.startswith("__")) == keys
        for k in keys:
            assert got[k].dtype == want[k].dtype, (rel, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{rel} {k}")
    contaminated = outs["torch"][Path("agg/2022_10_05_KeywordReading_Overt.mat")]
    assert contaminated["ecog"].shape[1] == 63
    two = outs["torch"][Path("agg/2022_11_04_KeywordReading_Overt.mat")]
    one = outs["torch"][Path("agg/2022_11_03_KeywordReading_Overt.mat")]
    assert two["ecog"].shape[1] == 64
    assert two["ecog"].shape[0] > one["ecog"].shape[0] / 2 * 1.5


def test_aggregate_cli_writes_the_jax_files(corpus_root, tmp_path,
                                            monkeypatch):
    """The CLI's three arguments create the two folders and fill them
    with the files the JAX script's __main__ writes."""
    agg, timing = tmp_path / "a" / "agg", tmp_path / "a" / "timings"
    tagg.main(["--corpus-root", str(corpus_root), "--acc-path", str(agg),
               "--timing-path", str(timing)])
    days = ["2022_10_05", "2022_11_03", "2022_11_04"]
    assert sorted(p.name for p in agg.iterdir()) == \
        [f"{d}_KeywordReading_Overt.mat" for d in days]
    assert sorted(p.name for p in timing.iterdir()) == \
        [f"{d}_KeywordReading_Overt_timings.mat" for d in days]
    for missing in (["--corpus-root", str(corpus_root)], []):
        with pytest.raises(SystemExit):
            tagg.main(missing)


def _options(main, capsys):
    with pytest.raises(SystemExit):
        main()
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))


def test_contamination_cli_arguments_match_jax(capsys, monkeypatch):
    """The port's CLI takes the JAX CLI's arguments (--agg-path and --out,
    both required) and one more, --device."""
    monkeypatch.setattr(sys, "argv", ["contamination_analysis.py", "--help"])
    want = _options(jca.main, capsys)
    got = _options(lambda: tcore.main(["--help"]), capsys)
    assert want == {"--help", "--agg-path", "--out"}
    assert got == want | {"--device"}
    for argv in (["--out", "x"], ["--agg-path", "x"]):
        with pytest.raises(SystemExit):
            tcore.main(argv)


def test_contamination_cli_writes_the_jax_files(tmp_path, monkeypatch):
    """On the same aggregated days: the same result files, each holding
    the same ``out`` fields, measures within rtol 1e-4 and the same
    criterion."""
    agg = tmp_path / "agg"
    agg.mkdir()
    rng = np.random.default_rng(4)
    for day, dirty in (("2022_09_22", False), ("2022_09_23", True)):
        T = 12 * 1000
        audio = rng.normal(size=T) * (0.1 + (np.arange(T) % 4000 < 2000))
        ecog = rng.normal(size=(T, 32))
        if dirty:
            ecog[:, 3] += 5.0 * audio
        savemat(str(agg / f"{day}_KeywordReading_Overt.mat"),
                dict(fs=1000, ecog=ecog, audio=audio))
    monkeypatch.setattr(jcore, "NB_SURROGATES", 8)
    monkeypatch.setattr(tcore, "NB_SURROGATES", 8)
    monkeypatch.setattr(sys, "argv", ["contamination_analysis.py",
                                      "--agg-path", str(agg), "--out",
                                      str(tmp_path / "jax")])
    jca.main()
    tcore.main(["--agg-path", str(agg), "--out", str(tmp_path / "torch"),
                "--device", "cpu"])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["2022_09_22_contamination_result.mat",
                     "2022_09_23_contamination_result.mat"]
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == names
    for name in names:
        want = loadmat(str(tmp_path / "jax" / name), simplify_cells=True)["out"]
        got = loadmat(str(tmp_path / "torch" / name), simplify_cells=True)["out"]
        assert sorted(got) == sorted(want)
        assert got["dataset_measure"] == want["dataset_measure"]
        np.testing.assert_allclose(got["surrogate_measures"],
                                   want["surrogate_measures"], rtol=1e-4)
        assert got["criterion_value"] == want["criterion_value"]


def test_gen_contamination_report_imports_neither_jax_nor_dss_tpu():
    """The report script the pipeline runs by path is framework-free."""
    src = REPO / "eval" / "contamination" / "gen_contamination_report.py"
    roots = _imported_roots(src)
    assert "matplotlib" in roots and "numpy" in roots
    assert not roots & {"jax", "jaxlib", "dss_tpu", "dss_tpu_torch"}


@pytest.fixture(scope="module", params=["test_eval", "late_onsets"])
def fig_inputs(request, tmp_path_factory):
    """tests/test_eval.py's inputs for suppl_fig_2 (14 s at 1 kHz, three
    2 s trials, an audio channel loud over each trial: the onset is each
    trial's first frame, so no trial has its 0.5 s before onset and every
    channel stays at zero), and the same with the speech starting 0.7 s
    into each trial (every trial counts)."""
    tmp = tmp_path_factory.mktemp("fig")
    rng = np.random.default_rng(0)
    fs = 1000
    T = 14 * fs
    code = np.zeros(T, np.int16)
    speech = np.zeros(T, bool)
    lead = 0 if request.param == "test_eval" else 700
    for i in range(3):
        code[(1 + i * 4) * fs:(3 + i * 4) * fs] = 1
        speech[(1 + i * 4) * fs + lead:(3 + i * 4) * fs] = True
    base = {
        "parameters": {
            "SamplingRate": {"NumericValue": fs},
            "SourceChGain": {"NumericValue": np.ones(129)},
            "Stimuli": {"Value": np.array([["Enter"], ["1"]], dtype=object)},
        },
        "states": {"StimulusCode": code},
    }
    mat = dict(base)
    env = np.where(speech, 3.0, 0.2)
    signal = rng.normal(size=(T, 129))
    signal[:, 128] *= env * 10000
    if lead:
        signal[:, :128] *= np.where(speech, 2.0, 1.0)[:, None]
    mat["signal"] = signal
    mat_file = tmp / "KeywordReading_Overt_R01.mat"
    savemat(str(mat_file), mat)
    cal = dict(base)
    cal["signal"] = rng.normal(size=(T, 129))
    cal_file = tmp / "SyllableRepetition_Overt.mat"
    savemat(str(cal_file), cal)
    return mat_file, cal_file, 3 if lead else 0


def _jax_chan_specs(mat_file, cal_file, out_dir):
    """eval/suppl_fig_2.py's per-channel arrays, read back from the
    panels it draws (one imshow a channel, in the grid layout's order)."""
    import matplotlib.axes

    shown = []
    real = matplotlib.axes.Axes.imshow

    def record(self, x, *args, **kwargs):
        shown.append(np.array(x))
        return real(self, x, *args, **kwargs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(matplotlib.axes.Axes, "imshow", record)
        # Only the arrays are compared: skip laying out and saving the page.
        mp.setattr(jsf2.plt, "tight_layout", lambda *a, **k: None)
        mp.setattr(jsf2.plt, "savefig", lambda *a, **k: None)
        jsf2.gen_power_spectral_analysis_figure(mat_file, cal_file,
                                                out_dir=out_dir)
    jsf2.plt.close("all")
    layout = tsf2.grid_layout()
    order = [int(i) for i in layout.ravel() if not np.isnan(i)]
    specs = np.zeros((len(order),) + shown[0].shape, np.float32)
    for idx, x in zip(order, shown):
        specs[idx] = x
    assert len(shown) == 128
    return specs


def test_suppl_fig_2_arrays_match_jax(fig_inputs, tmp_path):
    """The onset-aligned dB change of every channel (atol 1e-4 dB), the
    baselines finite and positive, the arrays saved, the figure drawn, and
    the trials selected by keyword."""
    mat_file, cal_file, trials = fig_inputs
    want = _jax_chan_specs(mat_file, cal_file, tmp_path / "jax")
    out = tsf2.gen_power_spectral_analysis_figure(
        mat_file, cal_file, out_dir=tmp_path / "torch", device="cpu")
    got = out["chan_specs"]
    assert got.shape == want.shape == (128, 51, 200)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=DB_ATOL)
    assert out["trials_used"] == trials and len(out["onsets"]) == 3
    assert (np.abs(got).max() > 1.0) == bool(trials)  # the bursts show
    assert np.all(out["norm_stats"] > 0)
    assert out["figure"] == tmp_path / "torch" / "suppl_fig_2.png"
    assert out["figure"].exists()
    saved = np.load(tmp_path / "torch" / "suppl_fig_2.npz")
    np.testing.assert_array_equal(saved["chan_specs"], got)
    # Every trial is an "Enter" trial; a word no trial carries leaves
    # every channel at zero.
    enter = tsf2.spectral_change(mat_file, cal_file, keyword="Enter",
                                 device="cpu")
    np.testing.assert_array_equal(enter["chan_specs"], got)
    none = tsf2.spectral_change(mat_file, cal_file, keyword="nothing",
                                device="cpu")
    assert none["trials_used"] == 0 and not none["chan_specs"].any()


def test_suppl_fig_2_without_matplotlib(fig_inputs, tmp_path, monkeypatch):
    """Where matplotlib does not import, the arrays are computed and saved
    as before and no figure is claimed or written."""
    mat_file, cal_file, trials = fig_inputs
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tsf2.main([str(mat_file), str(cal_file), "--out", str(tmp_path),
                     "--device", "cpu"])
    assert out["figure"] is None
    assert not (tmp_path / "suppl_fig_2.png").exists()
    saved = np.load(tmp_path / "suppl_fig_2.npz")
    np.testing.assert_array_equal(saved["chan_specs"], out["chan_specs"])
    assert out["trials_used"] == trials


def _imported_roots(path: Path, seen=None) -> set:
    """The top-level names of every module ``path`` imports (at any
    depth of the file, inside functions too), following the port's own
    modules through their relative and absolute imports."""
    seen = set() if seen is None else seen
    if path in seen:
        return set()
    seen.add(path)
    roots = set()
    pkg = REPO / "dss_tpu_torch"
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = path.parent
                for _ in range(node.level - 1):
                    base = base.parent
                parts = (node.module or "").split(".") if node.module else []
                target = base.joinpath(*parts)
                subs = [target / a.name for a in node.names]
                for cand in [target] + subs:
                    f = cand.with_suffix(".py") if not cand.is_dir() \
                        else cand / "__init__.py"
                    if f.exists():
                        roots |= _imported_roots(f, seen)
                continue
            names = [node.module]
        for name in names:
            roots.add(name.split(".")[0])
            if name.split(".")[0] == "dss_tpu_torch":
                rel = name.split(".")[1:]
                f = pkg.joinpath(*rel)
                f = f / "__init__.py" if f.is_dir() else f.with_suffix(".py")
                if f.exists():
                    roots |= _imported_roots(f, seen)
    return roots


NEW_MODULES = [
    "dss_tpu_torch/eval/aggregate_per_day.py",
    "dss_tpu_torch/eval/suppl_fig_2.py",
    "dss_tpu_torch/eval/score_closed_loop.py",
    "dss_tpu_torch/eval/score_speech_run.py",
    "dss_tpu_torch/eval/keyword_intelligibility.py",
    "dss_tpu_torch/eval/vocoder_quality.py",
    "dss_tpu_torch/eval/score_vocoder_ship.py",
    "dss_tpu_torch/apps/replicate.py",
    "tools/torch_make_verify_fixtures.py",
]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_dss_tpu(module):
    """Read from the source, with the port modules each one imports: no
    import of jax or of the JAX package anywhere (h5py and matplotlib only
    inside functions, where they are optional)."""
    roots = _imported_roots(REPO / module)
    assert "torch" in roots or "numpy" in roots
    assert not roots & {"jax", "jaxlib", "dss_tpu", "flax", "optax"}, roots
