"""The port's vocoder training app (``dss_tpu_torch.apps.train_vocoder``)
against apps/train_vocoder.py, on the CPU, and its own rules: resume,
the inherited and partially pruned masks of ``--init-weights``,
best-by-validation under ``--val-wav``, checkpoints both packages load, the
refused default device, and imports without JAX.

The runs start from a tiny model (GRU-A 32, GRU-B 8, cond 16, embed 16)
given as ``--init-weights`` and train on a 0.2 s wav in chunks of 4 frames
at batch 2 (5 chunks, 2 steps an epoch).  Tolerances:
* two apps' ``vocoder.npz`` after one epoch at lr 1e-4: the mask exactly;
  every other parameter within 2 * lr a step (Adam's first updates are ~lr
  * sign(g), and the two encoders' features differ within their parity
  tolerance, so a gradient near zero may step the other way), and 99% of
  the elements within 1e-6;
* greedy synthesis from a port-written checkpoint in both packages: the
  same last excitation, and the float PCM within atol 5e-5 (the 16-tap
  synthesis filter and the de-emphasis carry each sample's rounding into
  the next ones, and this trained model's PCM reaches 0.8: 1.8e-5
  measured).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io.wavfile import write as wavwrite

from dss_tpu.vocoder import LPCNetModel as JModel
from dss_tpu.vocoder import net as jnet
from dss_tpu_torch.apps import train_vocoder as app
from dss_tpu_torch.vocoder import net as tnet

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TINY = dict(gru_a_units=32, gru_b_units=8, cond_dim=16, embed_dim=16)
LR = 1e-4
STEPS = 2
COMMON = ["--batch", "2", "--chunk-frames", "4"]


def _wav(path, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds))
    audio = 3000 * np.sin(2 * np.pi * t / 91) + rng.normal(size=t.size) * 800
    path.parent.mkdir(parents=True, exist_ok=True)
    wavwrite(path, 16000, audio.astype(np.int16))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("vocoder_app")
    _wav(base / "wavs" / "utt.wav", 0.2, 0)
    for i in range(2):
        _wav(base / "val" / f"val_{i:02d}.wav", 0.15, 10 + i)
    init = base / "init.npz"
    np.savez(init, **jax.tree_util.tree_map(
        np.asarray, JModel(**TINY).init(jax.random.PRNGKey(0))))
    return base, init


def _port(base, out, *args):
    return app.main([str(base / "wavs"), str(out), *COMMON, "--device", "cpu",
                     *args])


def _log(out):
    return (Path(out) / "training.log").read_text()


def test_apps_write_equal_checkpoints(corpus):
    """Both apps, one epoch from the same --init-weights without noise:
    vocoder.npz key for key at the module's tolerance."""
    base, init = corpus
    args = ["--epochs", "1", "--noise-level", "0", "--density", "1.0",
            "--lr", str(LR), "--init-weights", str(init)]
    r = subprocess.run(
        [sys.executable, str(REPO / "apps" / "train_vocoder.py"),
         str(base / "wavs"), str(base / "jax"), *COMMON, *args,
         "--platform", "cpu"], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    history = _port(base, base / "port", *args)
    assert len(history) == 1 and np.isfinite(history[0])
    with np.load(base / "jax" / "vocoder.npz") as fj, \
            np.load(base / "port" / "vocoder.npz") as ft:
        assert sorted(fj.files) == sorted(ft.files)
        np.testing.assert_array_equal(ft["gru_a_mask"], fj["gru_a_mask"])
        close, total = 0, 0
        for k in fj.files:
            assert ft[k].dtype == fj[k].dtype == np.float32, k
            np.testing.assert_allclose(ft[k], fj[k], atol=2 * LR * STEPS,
                                       err_msg=k)
            close += int(np.sum(np.abs(ft[k] - fj[k]) <= 1e-6))
            total += fj[k].size
        assert close >= 0.99 * total, close / total


def test_resume_continues_the_epoch_counter(corpus, tmp_path):
    base, init = corpus
    out = tmp_path / "out"
    args = ["--density", "1.0", "--init-weights", str(init)]
    assert len(_port(base, out, "--epochs", "1", *args)) == 1
    blob = torch.load(out / "train_state.pth")
    assert blob["extra"]["epoch"] == 1
    history = _port(base, out, "--epochs", "3", "--resume", *args)
    assert len(history) == 2
    blob = torch.load(out / "train_state.pth")
    assert blob["extra"]["epoch"] == 3
    assert "gru_a_wh" in blob["model"]
    assert all(s["step"] == 3 * STEPS
               for s in blob["optimizer"]["state"].values())
    assert "Resumed from" in _log(out)


@pytest.fixture(scope="module")
def pruned(corpus):
    """Stage 1: two epochs pruned to 0.5 (the ramp completes)."""
    base, init = corpus
    out = base / "stage1"
    _port(base, out, "--epochs", "2", "--density", "0.5", "--init-weights",
          str(init))
    with np.load(out / "vocoder.npz") as f:
        mask = f["gru_a_mask"]
    assert 0 < mask.mean() <= 0.5 + 1e-6
    return out / "vocoder.npz", mask


def test_init_weights_inherits_pruned_mask(corpus, pruned, tmp_path):
    """From a checkpoint pruned to the target, the mask is kept fixed (as
    tests/test_vocoder_train.py holds the JAX app): 5 epochs would put the
    ramp's start at epoch 1 and re-sparsify at ~0.9 otherwise."""
    base, _ = corpus
    npz, mask_in = pruned
    _port(base, tmp_path, "--epochs", "5", "--density", "0.5",
          "--init-weights", str(npz))
    assert "pruning disabled, mask inherited" in _log(tmp_path)
    with np.load(tmp_path / "vocoder.npz") as f:
        np.testing.assert_array_equal(f["gru_a_mask"], mask_in)


def test_init_weights_partial_mask_ramps_from_checkpoint_density(
        corpus, pruned, tmp_path):
    """From a checkpoint denser than the target, the ramp starts at ITS
    density, never above, ends at the target, and regrows nothing."""
    base, _ = corpus
    npz, mask_in = pruned
    d_in = mask_in.mean()
    _port(base, tmp_path, "--epochs", "5", "--density", "0.25",
          "--init-weights", str(npz))
    log_text = _log(tmp_path)
    assert "prune ramp starts at the checkpoint density" in log_text
    densities = [float(m.split("GRU-A density ")[1].rstrip(")"))
                 for m in log_text.splitlines() if "GRU-A density" in m]
    assert len(densities) == 5 and max(densities) <= d_in + 1e-2
    with np.load(tmp_path / "vocoder.npz") as f:
        mask_out = f["gru_a_mask"]
    assert mask_out.mean() <= 0.25 + 1e-3
    assert np.all(mask_out <= mask_in + 1e-6)


def test_val_wav_keeps_the_best_checkpoint(corpus, tmp_path):
    """--val-wav DIR scores the first --val-max-wavs wavs free-running every
    --score-every epochs and keeps the best as vocoder_best.npz; the
    density gate passes (dense model, target 1.0)."""
    base, init = corpus
    _port(base, tmp_path, "--epochs", "2", "--density", "1.0",
          "--init-weights", str(init), "--val-wav", str(base / "val"),
          "--score-every", "1", "--val-max-wavs", "2")
    log_text = _log(tmp_path)
    assert log_text.count("mean over 2 wav(s)") == 2
    assert "new best val score" in log_text
    with np.load(tmp_path / "vocoder_best.npz") as best, \
            np.load(tmp_path / "vocoder.npz") as last:
        assert sorted(best.files) == sorted(last.files)
    blob = torch.load(tmp_path / "train_state.pth")
    assert np.isfinite(blob["extra"]["best_score"])


def test_port_checkpoint_loads_in_jax_and_synthesizes_the_same(
        corpus, pruned):
    """A port-written, pruned vocoder.npz loads in the JAX package's
    LPCNetModel.from_params and synthesizes greedily what the port does."""
    base, _ = corpus
    npz, _ = pruned
    with np.load(npz) as f:
        params = {k: f[k] for k in f.files}
    jm = JModel.from_params(params)
    assert (jm.gru_a_units, jm.bunch) == (32, 1)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(1, 2, 20)).astype(np.float32) * 0.3
    feats[..., 0] -= 4.0
    pcm_j, jst = jnet.net_synthesize_frames(
        jm, {k: jnp.asarray(v) for k, v in params.items()},
        jnet.net_vocoder_init(jm, batch=1), jnp.asarray(feats), greedy=True)
    tm = tnet.LPCNetModel.from_params(params)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    pcm_t, tst = tnet.net_synthesize_frames(
        tm, tp, tnet.net_vocoder_init(tm, batch=1, device="cpu"),
        torch.as_tensor(feats), greedy=True)
    np.testing.assert_array_equal(tst.exc_idx.numpy(), np.asarray(jst.exc_idx))
    np.testing.assert_allclose(tst.sig_mem.numpy(), np.asarray(jst.sig_mem),
                               atol=5e-5)
    np.testing.assert_allclose(pcm_t.numpy(), np.asarray(pcm_j), atol=5e-5)


def test_default_device_is_refused_without_a_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    base, _ = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main([str(base / "wavs"), str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


NEW_MODULES = [
    "dss_tpu_torch.apps.train_vocoder", "dss_tpu_torch.train",
    "dss_tpu_torch.train.trainer_vocoder", "dss_tpu_torch.train.optim",
    "dss_tpu_torch.train.checkpoints", "dss_tpu_torch.ops.lpc_recursion",
    "dss_tpu_torch.convert", "dss_tpu_torch.vocoder.net",
]


def test_vocoder_training_modules_import_without_jax():
    """Every module of vocoder training imports in a fresh interpreter where
    jax cannot be imported, and loads nothing of dss_tpu."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'dss_tpu' or k.startswith('dss_tpu.') "
            "for k in sys.modules)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
