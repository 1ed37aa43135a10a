"""The port's ``eval/score_exteval.py`` against tools/score_exteval.py on
the CPU.

* ``split_registers`` of both on the synthetic reports of
  tests/test_score_exteval.py: equal;
* both tools' ``main`` on one ``--reuse-corpus --cached-sweep`` directory
  (every sweep point cached, so the JAX tool starts no subprocess): equal
  artifacts, key for key;
* the three inputs on which the JAX tool goes wrong (ADVICE.md) raise in
  the port before any corpus is made or scored;
* one run of the port in this process, through its own LPCNet on a tiny
  checkpoint (the plain sampler on the CPU), on a 2-word harmonic-plus-
  noise corpus of both registers.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dss_tpu_torch.eval import score_exteval as tse
from dss_tpu_torch.vocoder import net as tnet

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_score_exteval", REPO / "tools" / "score_exteval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(pattern):
    """Margin rows of tests/test_score_exteval.py's two reports."""
    if pattern == "mapping":
        margins = []
        for word in ("back", "down"):
            margins += [
                {"word": word, "predicted": word, "margin": 0.5},
                {"word": word, "predicted": word, "margin": 0.3},
                {"word": word, "predicted": word, "margin": 0.05},
                {"word": word, "predicted": "up", "margin": -0.02},
            ]
        return margins
    return [{"word": "back", "predicted": "back", "margin": 0.4},
            {"word": "back", "predicted": "back"},
            {"word": "back", "predicted": "back", "margin": 0.2},
            {"word": "back", "predicted": "back", "margin": 0.1}]


@pytest.mark.parametrize("pattern", ["mapping", "nonfinite"])
def test_split_registers_equal_jax(pattern):
    report = {"margins": _rows(pattern)}
    assert tse.split_registers(report, 2) == \
        _jax_tool().split_registers(report, 2)


def _report(seed, words=("back", "down", "up"), per_word=4):
    """A keyword_intelligibility-shaped report with seeded rows."""
    rng = np.random.default_rng(seed)
    margins = []
    for w in words:
        for _ in range(per_word):
            right = rng.random() < 0.75
            margins.append({"word": w, "predicted": w if right else "up",
                            "margin": round(float(rng.normal(0.2, 0.1)), 4)})
    vals = [m["margin"] for m in margins]
    return {
        "keyword_id_accuracy": round(float(np.mean(
            [m["word"] == m["predicted"] for m in margins])), 4),
        "confusion": {w: {w: per_word} for w in words},
        "margins": margins,
        "margin_min": round(float(np.min(vals)), 4),
        "margin_median": round(float(np.median(vals)), 4),
        "chance": round(1 / len(words), 4), "num_words": len(words),
        "num_utterances": len(margins),
        "cepstral_distance_db_mean": round(float(rng.uniform(8, 12)), 3),
        "stoi_mean": round(float(rng.uniform(0.5, 0.8)), 4),
        "backend": "net", "syn_dir": None, "weights": "w.npz",
        "temperature_scale": 1.0, "per_word": {}}


@pytest.fixture
def cached_sweep(tmp_path):
    sweep = tmp_path / "sweep"
    sweep.mkdir()
    for k, t in enumerate((0.85, 1.0, 1.3)):
        (sweep / f"t{t:g}.json").write_text(json.dumps(_report(k)))
    return sweep


def test_main_on_a_cached_sweep_equals_jax(cached_sweep, tmp_path,
                                           monkeypatch, capsys):
    args = ["--reuse-corpus", "--corpus-dir", str(tmp_path / "nowhere"),
            "--cached-sweep", str(cached_sweep), "--temps", "0.85,1.0,1.3",
            "--headline-temp", "1.0", "--seed", "7"]

    def no_subprocess(*a, **k):
        raise AssertionError("a subprocess was started")
    jtool = _jax_tool()
    monkeypatch.setattr(jtool.subprocess, "run", no_subprocess)
    monkeypatch.setattr(sys, "argv", ["score_exteval.py", *args,
                                      "--out", str(tmp_path / "jax.json")])
    jtool.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    monkeypatch.setattr(tse.subprocess, "run", no_subprocess)
    got = tse.main([*args, "--out", str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert json.loads(json.dumps(got)) == want
    assert [p["temperature_scale"] for p in want["temperature_sweep"]] == \
        [0.85, 1.0, 1.3]
    err = capsys.readouterr().err
    assert err.count("temp 1: acc") == 2  # both tools' progress lines


@pytest.mark.parametrize("argv, match", [
    (["--variants", "6"], "register split is wrong"),
    (["--temps", "1.0,1.3", "--headline-temp", "0.9"],
     "--headline-temp 0.9 is not one of"),
])
def test_bad_arguments_fail_before_any_work(argv, match, tmp_path,
                                            monkeypatch, capsys):
    monkeypatch.setattr(tse.subprocess, "run", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("corpus made")))
    with pytest.raises(SystemExit):
        tse.main([*argv, "--corpus-dir", str(tmp_path)])
    assert match in capsys.readouterr().err


def test_a_register_without_rows_fails_before_scoring(tmp_path, monkeypatch):
    """One keyword file a word and one variant: no female rows."""
    from scipy.io import wavfile
    for w in ("back", "down"):
        wavfile.write(tmp_path / f"kw_{w}_0.wav", 16000,
                      np.zeros(1600, np.int16))
    monkeypatch.setattr(tse, "run_eval", lambda *a: (
        _ for _ in ()).throw(AssertionError("scored")))
    with pytest.raises(ValueError, match="register 'female'"):
        tse.main(["--reuse-corpus", "--corpus-dir", str(tmp_path),
                  "--variants", "1", "--temps", "1.0",
                  "--out", str(tmp_path / "a.json")])
    male_only = {"margins": [{"word": "back", "predicted": "back",
                              "margin": 0.3}]}
    with pytest.raises(ValueError, match="register 'female'"):
        tse.split_registers(male_only, 1)


def test_port_in_process_on_a_two_word_hnm_corpus(tmp_path):
    """make_hnm_corpus.py at one variant of both registers, cut to two
    words and their first 0.3 s, round-tripped through a tiny bunch-1
    checkpoint on the CPU."""
    from scipy.io import wavfile
    corpus = tmp_path / "hnm"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_hnm_corpus.py"),
                    "--out", str(corpus), "--seed", "3", "--variants", "1",
                    "--sentences", "0", "--registers", "male,female"],
                   check=True, capture_output=True)
    for f in corpus.glob("kw_*.wav"):
        if f.name.split("_")[1] not in ("up", "down"):
            f.unlink()
        else:  # 0.3 s a word: the plain sampler takes ~0.1 s a frame
            wavfile.write(f, 16000, wavfile.read(f)[1][:4800])
    model = tnet.LPCNetModel(gru_a_units=16, gru_b_units=8, cond_dim=8,
                             embed_dim=8)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    weights = tmp_path / "tiny.npz"
    np.savez(weights, **{k: v.numpy() for k, v in params.items()})
    out = tmp_path / "art.json"
    art = tse.main(["--reuse-corpus", "--corpus-dir", str(corpus),
                    "--weights", str(weights), "--device", "cpu",
                    "--variants", "1", "--temps", "1.0",
                    "--headline-temp", "1.0", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(art))
    assert art["num_words"] == 2 and art["num_utterances"] == 4
    assert art["registers"] == ["male", "female"]
    assert {r: art["per_register"][r]["n"] for r in ("male", "female")} == \
        {"male": 2, "female": 2}
    assert np.isfinite(art["cepstral_distance_db_mean"])
    assert art["headline_temperature_scale"] == 1.0
    assert len(art["temperature_sweep"]) == 1
