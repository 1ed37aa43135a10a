"""The port's scorers against the JAX scripts, on the CPU, on the same
waveforms and logged features: ``eval/score_closed_loop.py`` against
tools/score_closed_loop.py, ``eval/score_speech_run.py`` against
tools/score_speech_run.py, ``eval/keyword_intelligibility.py`` and
``eval/vocoder_quality.py`` against the eval/ scripts of those names, and
``eval/score_vocoder_ship.py`` against tools/score_vocoder_ship.py.

Where a script vocodes, both sides get the same stand-in vocoder
(``Rendering``: it returns, for a call of T frames, a fixed waveform
registered for T frames, scaled and with fixed noise), so the reports
compare the scorers, not two random streams (the two packages share no
PRNG; the vocoders themselves are held to each other in
tests/test_torch_vocoder_api.py and tests/test_torch_quality.py).  One
test runs the port's real ``LPCNet`` on a tiny checkpoint.

Tolerances: what is host numpy in both (segment reading and mapping,
trimming, dithering, STOI of the same samples) is equal; what goes through
the feature encoder carries its float32 differences between the
frameworks (tests/test_torch_quality.py: distances atol 1e-3 dB, keyword
reports equal in every prediction with margins atol 1e-3).  The reports
round to 2-4 decimals, so a rounded value may sit one unit of its last
decimal apart: dB atol 2e-3 (0.011 where rounded to 2 decimals); STOI of
the same samples within 1e-9."""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import dss_tpu.vocoder as jvoc
import dss_tpu.vocoder.dsp as jdsp
import dss_tpu.vocoder.lpcnet as jlpcnet
from dss_tpu.vocoder import net as jnet
from dss_tpu_torch.eval import keyword_intelligibility as tki
from dss_tpu_torch.eval import score_closed_loop as tscl
from dss_tpu_torch.eval import score_speech_run as tssr
from dss_tpu_torch.eval import score_vocoder_ship as tsvs
from dss_tpu_torch.eval import vocoder_quality as tvq
from dss_tpu_torch.vocoder.features import LPCFeatureEncoder

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO / "eval"))
torch.set_num_threads(1)

import keyword_intelligibility as jki  # noqa: E402
import make_speech_corpus as msc  # noqa: E402
import score_closed_loop as jscl  # noqa: E402
import score_speech_run as jssr  # noqa: E402
import score_vocoder_ship as jsvs  # noqa: E402
import vocoder_quality as jvq  # noqa: E402

FS = 16000
DB = 2e-3
WORDS = ("enter", "up", "down")


class Rendering:
    """Stand-in vocoder with the LPCNet frame API: a call of T frames
    returns ``BANK[T]`` (zeros where none is registered) times 0.8 plus
    noise seeded by T, as int16 [T * 160]."""

    BANK = {}

    def __init__(self, *args, **kwargs):
        pass

    def reset_decoder(self):
        pass

    def synthesize_frames(self, feats):
        n = len(feats) * 160
        src = np.zeros(n)
        bank = self.BANK.get(len(feats))
        if bank is not None:
            src[:min(n, len(bank))] = bank[:n]
        noise = np.random.default_rng(len(feats)).normal(0.0, 200.0, n)
        return np.clip(0.8 * src + noise, -32768, 32767).astype(np.int16)


def _pcm(w, rng):
    y = w / (np.max(np.abs(w)) + 1e-9) + rng.normal(0, 1e-3, len(w))
    return (np.clip(y * 0.55, -1, 1) * 32767).astype(np.int16)


@pytest.fixture(scope="module")
def words():
    """{word: [two int16 renderings]} from tools/make_speech_corpus.py's
    synthesizer, each a distinct number of 10 ms frames (the stand-in
    vocoder keys its bank by frame count)."""
    rng = np.random.default_rng(21)
    out, seen = {}, set()
    for word in WORDS:
        for f0 in (110.0, 135.0):
            pcm = _pcm(msc.synth_word(msc.KEYWORDS[word], rng, f0=f0), rng)
            while len(pcm) // 160 in seen:
                pcm = np.concatenate([pcm, np.zeros(160, np.int16)])
            seen.add(len(pcm) // 160)
            out.setdefault(word, []).append(pcm)
    return out


@pytest.fixture
def bank(words):
    """Every keyword rendering registered in the stand-in's bank under
    its frame count."""
    Rendering.BANK = {len(w) // 160: w for ws in words.values() for w in ws}
    yield Rendering.BANK
    Rendering.BANK = {}


def _write_kw(directory, words):
    directory.mkdir(parents=True, exist_ok=True)
    for word, ws in words.items():
        for i, w in enumerate(ws):
            wavfile.write(directory / f"kw_{word}_{i}.wav", FS, w)
    return directory


@pytest.fixture
def run_dir(tmp_path, words):
    """A decode_online run directory: each keyword's first rendering
    encoded to the logged features, the segment lengths in log.vad.lab
    (replay times 3 s apart, one of them past the 18 s session), and as
    reco what the stand-in vocoder renders from them (the word with noise
    when ``bank`` was set up first, else noise alone)."""
    d = tmp_path / "run"
    (d / "reco").mkdir(parents=True)
    enc = LPCFeatureEncoder(device="cpu")
    rows, lab = [], []
    for i, word in enumerate(WORDS):
        w = words[word][0]
        f = enc.compute_LPC_features(w)
        rows.append(f)
        start = 3.0 + 6.0 * i + (18.0 if i == 2 else 0.0)
        lab.append(f"{start:.2f}\t{start + len(f) / 100:.2f}\t"
                   f"{len(f)} frames\n")
        wavfile.write(d / "reco" / f"reco_{i + 1:05d}.wav", FS,
                      Rendering().synthesize_frames(f))
    np.concatenate(rows).astype(np.float32).tofile(d / "log.lpc.f32")
    (d / "log.vad.lab").write_text("".join(lab))
    (d / "log.run.txt").write_text(
        "[x] vocoder: backend=net weights=weights/voc.npz; fused=True\n")
    return d


def _jax_main(module, argv, monkeypatch, capsys):
    """A JAX script's ``main`` with ``argv``; -> the JSON line it printed
    last."""
    monkeypatch.setattr(sys, "argv", ["script.py"] + argv)
    module.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _close(got, want, path="", db=DB):
    """``got`` equals ``want`` key for key; floats within ``db``, STOI
    within 1e-9 (module docstring)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}", db)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]", db)
    elif isinstance(want, float):
        atol = 1e-9 if "stoi" in path else db
        assert got == pytest.approx(want, abs=atol), path
    else:
        assert got == want, path


# ---- score_closed_loop ------------------------------------------------------

def test_read_segments_equal_jax(run_dir):
    got_f, got_r = tscl.read_segments(str(run_dir))
    want_f, want_r = jscl.read_segments(str(run_dir))
    assert len(got_f) == len(want_f) == 3
    for a, b in zip(got_f + got_r, want_f + want_r):
        np.testing.assert_array_equal(a, b)


def test_partial_runs_are_refused_as_in_jax(run_dir):
    """A log.vad.lab whose frames disagree with log.lpc.f32, or a reco wav
    of the wrong length: both packages stop."""
    lab = (run_dir / "log.vad.lab").read_text()
    (run_dir / "log.vad.lab").write_text(lab.replace(" frames", "0 frames",
                                                     1))
    for mod in (tscl, jscl):
        with pytest.raises(SystemExit, match="partial"):
            mod.read_segments(str(run_dir))
    (run_dir / "log.vad.lab").write_text(lab)
    _, audio = wavfile.read(run_dir / "reco" / "reco_00002.wav")
    wavfile.write(run_dir / "reco" / "reco_00002.wav", FS, audio[:-1])
    for mod in (tscl, jscl):
        with pytest.raises(SystemExit, match="samples"):
            mod.read_segments(str(run_dir))


def test_fidelity_db_matches_jax(run_dir):
    feats, recos = tscl.read_segments(str(run_dir))
    for f, r in zip(feats, recos):
        got = tscl.fidelity_db(f, r, device="cpu")
        assert got == pytest.approx(jscl.fidelity_db(f, r), abs=1e-3)
        assert 0.0 < got < 30.0


def test_score_closed_loop_report_matches_jax(run_dir, bank, tmp_path,
                                              monkeypatch, capsys):
    """The whole report (per segment: frames, online, offline, delta),
    with --min-frames, --limit and --quiet-sharpen, on the stand-in
    vocoder; --out holds what stdout printed."""
    monkeypatch.setattr(jlpcnet, "LPCNet", Rendering)
    monkeypatch.setattr(tscl, "LPCNet", Rendering)
    args = [str(run_dir), "--weights", "weights/voc.npz", "--min-frames",
            "30", "--limit", "2", "--quiet-sharpen"]
    want = _jax_main(jscl, args + ["--out", str(tmp_path / "j.json")],
                     monkeypatch, capsys)
    got = tscl.main(args + ["--device", "cpu", "--out",
                            str(tmp_path / "t.json")])
    assert got["n_segments"] == 2
    _close(got, want)
    assert json.loads((tmp_path / "t.json").read_text()) == got
    assert "WARNING" not in capsys.readouterr().err


def _tiny_checkpoint(path):
    jm = jnet.LPCNetModel(bunch=1, gru_a_units=16, gru_b_units=8,
                          cond_dim=8, embed_dim=8)
    np.savez(path, **jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))
    return path


def test_score_closed_loop_through_the_port_vocoder(run_dir, tmp_path,
                                                    capsys):
    """The offline resynthesis through the port's own LPCNet (a tiny
    bunch-1 checkpoint; its plain sampler on the CPU): one segment scored,
    finite, and a warning that the run logged another checkpoint."""
    weights = _tiny_checkpoint(tmp_path / "tiny.npz")
    feats, recos = tscl.read_segments(str(run_dir))
    feats[0][:20].tofile(run_dir / "log.lpc.f32")      # one 20-frame segment
    (run_dir / "log.vad.lab").write_text("3.00\t3.20\t20 frames\n")
    wavfile.write(run_dir / "reco" / "reco_00001.wav", FS, recos[0][:3200])
    got = tscl.score_run(str(run_dir), str(weights), min_frames=1,
                         device="cpu")
    assert got["n_segments"] == 1 and got["segments"][0]["frames"] == 20
    row = got["segments"][0]
    assert np.isfinite([row["online_db"], row["offline_db"]]).all()
    assert "WARNING: run used 'backend=net weights=weights/voc.npz'" in \
        capsys.readouterr().err


# ---- score_speech_run -------------------------------------------------------

ORDER = {"session_seconds": 18.0,
         "words": [{"word": "enter", "t0": 3.0, "t1": 5.0},
                   {"word": "up", "t0": 9.0, "t1": 11.0},
                   {"word": "down", "t0": 15.0, "t1": 17.0}]}


def test_map_segments_to_words_equal_jax(tmp_path):
    """Nearest centre modulo the session, a looped replay, a segment far
    from every word skipped, a malformed line ignored."""
    (tmp_path / "log.vad.lab").write_text(
        "3.10\t4.60\t150 frames\n"
        "9.50\t11.20\t170 frames\n"
        "33.20\t34.90\t170 frames\n"     # second loop: 'down'
        "7.00\t7.10\t10 frames\n"        # 3 s from every centre
        "garbage\n"
        "21.30\t23.00\t170 frames\n")    # second loop: 'enter'
    got = tssr.map_segments_to_words(str(tmp_path), ORDER)
    assert got == jssr.map_segments_to_words(str(tmp_path), ORDER)
    assert got == ([(1, "enter"), (2, "up"), (3, "down"), (6, "enter")], 1)


def test_energy_trim_and_floor_dither_equal_jax(words):
    w = np.concatenate([np.zeros(4000, np.int16), words["up"][0],
                        np.full(3000, 5, np.int16)])
    got = tssr.energy_trim(w)
    np.testing.assert_array_equal(got, jssr.energy_trim(w))
    assert 0 < len(got) < len(w)
    silent = np.zeros(1000, np.int16)
    np.testing.assert_array_equal(tssr.energy_trim(silent),
                                  jssr.energy_trim(silent))
    np.testing.assert_array_equal(
        tssr._floor_dither(w, np.random.default_rng(1)),
        jssr._floor_dither(w, np.random.default_rng(1)))


def test_score_speech_run_report_matches_jax(bank, run_dir, words, tmp_path,
                                             monkeypatch, capsys):
    """Own and shifted templates: the mapping, keyword ID, confusion,
    margins and STOI as the JAX script reports them."""
    base = tmp_path / "dataset"
    _write_kw(base / "keyword_templates", words)
    (base / "word_order.json").write_text(json.dumps(ORDER))
    rng = np.random.default_rng(5)
    shifted = _write_kw(tmp_path / "shifted", {
        w: [np.clip(v * 0.7 + rng.normal(0, 300, len(v)), -32768, 32767)
            .astype(np.int16) for v in vs] for w, vs in words.items()})
    want = _jax_main(jssr, [str(run_dir), str(base), "--shifted-dir",
                            str(shifted)], monkeypatch, capsys)
    got = tssr.main([str(run_dir), str(base), "--shifted-dir", str(shifted),
                     "--device", "cpu", "--out", str(tmp_path / "t.json")])
    assert got["n_segments_scored"] == 3
    assert got["vs_own_templates"]["keyword_id_accuracy"] == 1.0
    _close(got, want)
    assert json.loads((tmp_path / "t.json").read_text()) == got


# ---- keyword_intelligibility ------------------------------------------------

@pytest.fixture
def kw_dir(tmp_path, words):
    return _write_kw(tmp_path / "kw", words)


def test_keyword_intelligibility_pre_rendered_matches_jax(
        kw_dir, words, tmp_path, monkeypatch, capsys):
    """--syn-dir: renderings scored against the originals."""
    rng = np.random.default_rng(8)
    syn = _write_kw(tmp_path / "syn", {
        w: [np.clip(v + rng.normal(0, 500, len(v)), -32768, 32767)
            .astype(np.int16) for v in vs] for w, vs in words.items()})
    want = _jax_main(jki, [str(kw_dir), "--syn-dir", str(syn)], monkeypatch,
                     capsys)
    got = tki.main([str(kw_dir), "--syn-dir", str(syn), "--device", "cpu"])
    assert got["keyword_id_accuracy"] == 1.0 and got["num_utterances"] == 6
    _close(got, want)


def test_keyword_intelligibility_vocoder_mode_matches_jax(
        kw_dir, bank, monkeypatch, capsys):
    """Round trips through the (stand-in) vocoder, with a noise sweep."""
    monkeypatch.setattr(jlpcnet, "LPCNet", Rendering)
    monkeypatch.setattr(tki, "LPCNet", Rendering)
    args = [str(kw_dir), "--backend", "net", "--weights", "w.npz",
            "--snr-sweep", "10"]
    want = _jax_main(jki, args, monkeypatch, capsys)
    got = tki.main(args + ["--device", "cpu"])
    assert set(got["noise_robustness"]) == {"10dB"}
    _close(got, want)


def test_keyword_intelligibility_rejects_a_short_syn_dir(kw_dir, words,
                                                         tmp_path):
    syn = _write_kw(tmp_path / "syn", {w: vs[:1] for w, vs in words.items()})
    with pytest.raises(SystemExit, match="rendering"):
        tki.main([str(kw_dir), "--syn-dir", str(syn), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no kw_"):
        tki.main([str(tmp_path), "--device", "cpu"])


# ---- vocoder_quality --------------------------------------------------------

def test_vocoder_quality_two_wavs_matches_jax(words, tmp_path, monkeypatch,
                                              capsys):
    ref, syn = tmp_path / "ref.wav", tmp_path / "syn.wav"
    wavfile.write(ref, FS, words["enter"][0])
    wavfile.write(syn, FS, Rendering().synthesize_frames(
        np.zeros((len(words["enter"][0]) // 160, 20))))
    want = _jax_main(jvq, [str(ref), str(syn)], monkeypatch, capsys)
    got = tvq.main([str(ref), str(syn), "--device", "cpu"])
    _close(got, want)
    with pytest.raises(SystemExit, match="SYN"):
        tvq.main([str(ref), "--device", "cpu"])


@pytest.mark.parametrize("backend", ["net", "dsp"])
def test_vocoder_quality_roundtrip_matches_jax(backend, words, bank,
                                               tmp_path, monkeypatch, capsys):
    ref = tmp_path / "ref.wav"
    wavfile.write(ref, FS, words["down"][1])
    monkeypatch.setattr(jvoc, "LPCNet", Rendering)
    monkeypatch.setattr(jdsp, "LPCVocoder", Rendering)
    monkeypatch.setattr(tvq, "LPCNet", Rendering)
    args = [str(ref), "--roundtrip", "--backend", backend]
    want = _jax_main(jvq, args, monkeypatch, capsys)
    got = tvq.main(args + ["--device", "cpu"])
    assert got["num_frames"] > 10
    _close(got, want)


# ---- score_vocoder_ship -----------------------------------------------------

def test_score_vocoder_ship_candidate_matches_jax(words, bank, tmp_path,
                                                  monkeypatch):
    """One corpus draw's val/ folder (the keywords and a sentence): the
    mean and max round-trip distortion, each wav's, keyword ID and STOI."""
    val = _write_kw(tmp_path / "val", words)
    sentence = _pcm(msc.synth_utterance(np.random.default_rng(2), 1.0)
                    .astype(np.float64), np.random.default_rng(3))
    wavfile.write(val / "val_00.wav", FS, sentence)
    Rendering.BANK[len(sentence) // 160] = sentence
    monkeypatch.setattr(jvoc, "LPCNet", Rendering)
    monkeypatch.setattr(tsvs, "LPCNet", Rendering)
    want = jsvs.score_candidate("w.npz", val, "auto")
    got = tsvs.score_candidate("w.npz", val, "cpu")
    assert len(got["per_wav_db"]) == 7 and got["keyword_id"] == 1.0
    _close(got, want, db=0.011)   # rounded to 2 decimals


def test_score_vocoder_ship_corpus_is_the_jax_scripts(monkeypatch, tmp_path):
    """Both draw the corpus with the same tool and arguments."""
    calls = []
    monkeypatch.setattr("subprocess.run",
                        lambda cmd, **kw: calls.append(cmd[1:]))
    assert tsvs.make_corpus(tmp_path, 777) == jsvs.make_corpus(tmp_path, 777)
    assert calls[0] == calls[1]
    assert calls[0][0].endswith("tools/make_speech_corpus.py")
    assert calls[0][1:] == [str(tmp_path), "--seconds", "4", "--seed", "777"]
