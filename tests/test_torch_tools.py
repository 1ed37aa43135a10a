"""The port's tools against the JAX scripts on the CPU:
tools/torch_bucket_sweep.py (tools/bucket_sweep.py),
tools/torch_make_import_fixture.py (tools/make_import_fixture.py),
tools/torch_vocoder_ab.py (tools/vocoder_ab.py) and
tools/torch_sampler_microbench.py (tools/sampler_microbench.py); and that
every module this slice adds imports neither jax nor the JAX package.

* the bucket sweep's cost model: the JSON lines of both tools equal, line
  for line, on ``synthetic_lengths(200, seed=3)``, on ``--synthetic 200``
  and on a ``.lab`` file; ``--measure`` on a 1-layer decoder: the keys,
  bucket counts and padding overheads of JAX's ``--measure --platform
  cpu`` (the times are each framework's own);
* the import fixture: its datasets equal those of the JAX tool's ``.h5``,
  and ``interop.params_from_datasets`` of them equals JAX's
  ``import_lpcnet_h5`` of that file, array for array and bit for bit; its
  ``.f32`` within the encoder's parity tolerances of the JAX tool's
  (tests/test_torch_dsp.py: cepstrum atol 1e-4, pitch period 1e-6,
  correlation 1e-5);
* the A/B harness on a tiny checkpoint (the plain sampler), on a tiny
  xiph-layout checkpoint through the ``datasets`` seam, and on the DSP
  vocoder with ``--rtf``, each against a reference rendering;
* the microbench: its tile-pattern summary equal to JAX's
  ``tile_sparse_pattern`` on the shipped mask, the JAX variants without a
  counterpart and ``--ablate`` raising, and one run on the CPU.
"""

import importlib.util
import json
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
torch.set_num_threads(1)

import torch_bucket_sweep as tbs  # noqa: E402
import torch_make_import_fixture as tfix  # noqa: E402
import torch_sampler_microbench as tmb  # noqa: E402
import torch_vocoder_ab as tab  # noqa: E402
from test_torch_replicate_eval import _imported_roots  # noqa: E402

from dss_tpu.ops.pallas.sampler import tile_sparse_pattern  # noqa: E402
from dss_tpu_torch.models.decoder import \
    BidirectionalSpeechSynthesisModel  # noqa: E402
from dss_tpu_torch.utils.audio import read_wav  # noqa: E402
from dss_tpu_torch.vocoder import interop as tinterop  # noqa: E402
from dss_tpu_torch.vocoder import net as tnet  # noqa: E402
from dss_tpu_torch.vocoder.lpcnet import LPCNet  # noqa: E402


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_lines(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    capsys.readouterr()
    mod.main()
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.fixture
def lab(tmp_path):
    rng = np.random.default_rng(11)
    path = tmp_path / "log.vad.lab"
    path.write_text("".join(f"{k:.2f}\t{k + n / 100:.2f}\t{n} frames\n"
                            for k, n in enumerate(rng.integers(40, 420, 40))))
    return path


# ---- bucket sweep -----------------------------------------------------------

def test_bucket_sweep_cost_model_rows_equal_jax():
    jbs = _jax_script("bucket_sweep")
    lengths = tbs.synthetic_lengths(200, seed=3)
    np.testing.assert_array_equal(lengths, jbs.synthetic_lengths(200, seed=3))
    mult = [10, 25, 50, 75, 100, 150]
    assert tbs.sweep(lengths, mult, 30.0, per_frame_s=150e-6) == \
        jbs.sweep(lengths, mult, 30.0, per_frame_s=150e-6)


@pytest.mark.parametrize("source", ["lab", "synthetic"])
def test_bucket_sweep_lines_equal_jax(source, lab, monkeypatch, capsys):
    argv = ["--lab", str(lab)] if source == "lab" else ["--synthetic", "200"]
    argv += ["--compile-cost", "12", "--multiples", "25", "50", "100"]
    want = _jax_lines(_jax_script("bucket_sweep"), argv, monkeypatch, capsys)
    got = tbs.main(argv)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert got == printed == want
    assert len(want) == 5


def test_bucket_sweep_measure_on_the_cpu_equals_jax_but_the_times(
        lab, monkeypatch, capsys):
    """A 1 x 8 decoder on both sides (JAX's tool builds its model inside
    ``sweep``, from the module attribute patched here)."""
    import dss_tpu.models.decoder as jdec
    monkeypatch.setattr(jdec, "BidirectionalSpeechSynthesisModel", partial(
        jdec.BidirectionalSpeechSynthesisModel, nb_layer=1,
        nb_hidden_units=8))
    argv = ["--lab", str(lab), "--measure", "--multiples", "100", "150"]
    want = _jax_lines(_jax_script("bucket_sweep"), argv + ["--platform",
                                                           "cpu"],
                      monkeypatch, capsys)
    model = BidirectionalSpeechSynthesisModel(1, 8, 64)
    got = tbs.main(argv + ["--device", "cpu"], model=model)
    assert got[0] == want[0]
    for g, w in zip(got[1:3], want[1:3]):
        assert list(g) == list(w)
        for key in ("length_multiple", "buckets", "padding_overhead"):
            assert g[key] == w[key], key
        assert g["mean_inference_ms"] > 0
        # No compile on the port: the session cost is the measured time.
        assert g["est_session_s"] == pytest.approx(
            g["mean_inference_ms"] * 40 / 1e3, abs=2e-3)
    assert list(got[3]) == list(want[3])


# ---- import fixture ---------------------------------------------------------

def test_fixture_datasets_and_params_equal_the_jax_fixture(tmp_path):
    pytest.importorskip("h5py")
    from dss_tpu.vocoder import interop as jinterop
    jfix = _jax_script("make_import_fixture")
    jfix.write_foreign_h5(str(tmp_path / "jax.h5"))
    ds = tfix.foreign_datasets()
    file_ds = tinterop.read_datasets(str(tmp_path / "jax.h5"))
    assert sorted(ds) == sorted(file_ds)
    for k in ds:
        assert ds[k].dtype == np.float32 and np.array_equal(ds[k], file_ds[k])
    got, model = tinterop.params_from_datasets(ds)
    want, jmodel = jinterop.import_lpcnet_h5(str(tmp_path / "jax.h5"))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    assert (model.gru_a_units, model.gru_b_units) == \
        (jmodel.gru_a_units, jmodel.gru_b_units) == (384, 16)
    assert "fc_out1_b" in got and "emb_pitch" in got


def test_fixture_main_writes_the_h5_and_the_f32(tmp_path, capsys):
    pytest.importorskip("h5py")
    jfix = _jax_script("make_import_fixture")
    ds = tfix.main(["--out-dir", str(tmp_path), "--seconds", "1",
                    "--device", "cpu"])
    written = tinterop.read_datasets(str(tmp_path / "xiph_like.h5"))
    assert all(np.array_equal(written[k], ds[k]) for k in ds)
    jfix.write_feature_file(str(tmp_path / "jax.f32"), seconds=1.0)
    got = np.fromfile(tmp_path / "feats.f32", np.float32).reshape(-1, 36)
    want = np.fromfile(tmp_path / "jax.f32", np.float32).reshape(-1, 36)
    assert got.shape == want.shape == (100, 36)
    assert not got[:, 20:].any() and not want[:, 20:].any()
    np.testing.assert_allclose(got[:, :18], want[:, :18], atol=1e-4)
    np.testing.assert_allclose(got[:, 18], want[:, 18], atol=1e-6)
    np.testing.assert_allclose(got[:, 19], want[:, 19], atol=1e-5)
    assert "wrote" in capsys.readouterr().out


def test_fixture_without_h5py_keeps_the_datasets_in_memory(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    def no_h5py(*a):
        raise ImportError("h5py")
    monkeypatch.setattr(tfix.interop, "write_datasets", no_h5py)
    ds = tfix.main(["--out-dir", str(tmp_path), "--seconds", "0.2",
                    "--device", "cpu"])
    assert not (tmp_path / "xiph_like.h5").exists()
    assert (tmp_path / "feats.f32").exists() and len(ds) == 19
    assert "h5py is not installed" in capsys.readouterr().out


# ---- A/B harness ------------------------------------------------------------

@pytest.fixture
def ab_inputs(tmp_path):
    """20 frames of the fixture's features and the DSP vocoder's rendering
    of them as a raw int16 reference."""
    feats = tfix.write_feature_file(str(tmp_path / "all.f32"), 0.2,
                                    device="cpu")
    assert feats.shape == (20, 20)
    ref = LPCNet(backend="dsp", device="cpu").synthesize_frames(feats)
    ref.astype(np.int16).tofile(tmp_path / "ref.pcm")
    model = tnet.LPCNetModel(gru_a_units=16, gru_b_units=8, cond_dim=8,
                             embed_dim=8)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    np.savez(tmp_path / "tiny.npz", **{k: v.numpy() for k, v in
                                       params.items()})
    return tmp_path


@pytest.mark.parametrize("source", ["npz", "datasets", "dsp"])
def test_vocoder_ab_against_a_reference(source, ab_inputs, capsys):
    tmp = ab_inputs
    argv = [str(tmp / "all.f32"), "--ref-pcm", str(tmp / "ref.pcm"),
            "--out", str(tmp / "ours.wav"), "--device", "cpu"]
    datasets = None
    if source == "npz":
        argv += ["--weights", str(tmp / "tiny.npz")]
    elif source == "datasets":
        datasets = tfix.foreign_datasets(1, gru_a=32, gru_b=16, cond=16,
                                         embed=8, pitch_dim=4, tame=True)
    else:
        argv += ["--rtf"]
    got = tab.main(argv, datasets=datasets)
    out = capsys.readouterr().out
    fs, wav = read_wav(str(tmp / "ours.wav"))
    assert fs == 16000 and wav.shape == (20 * 160,)
    assert got["frames"] == 20
    assert got["backend"] == ("dsp" if source == "dsp" else "net")
    ab = got["ab"]
    assert ab["samples"] == 3200
    assert np.isfinite([ab["cepstral_distance_db"],
                        ab["band_level_snr_db"]]).all()
    assert "A/B Bark-cepstral distortion" in out
    if source == "dsp":
        # The same vocoder and seed as the reference: the same samples.
        assert ab["cepstral_distance_db"] == pytest.approx(0.0, abs=1e-6)
        rtf = got["rtf"]
        assert rtf["rtf_wall"] > 0 and rtf["rtf_device"] is None
        assert "rtf:" in out


# ---- sampler microbench -----------------------------------------------------

def test_microbench_pattern_summary_equals_jax():
    with np.load(REPO / "weights" / "vocoder_synthetic.npz") as ck:
        mask = ck["gru_a_mask"]
    pattern, kept = tile_sparse_pattern(mask)
    assert tmb.pattern_summary(mask) == (kept, [len(r) for r in pattern])
    rand = tmb.sparse_mask(str(REPO / "no_such.npz"), (384, 1152))
    jpattern, jkept = tile_sparse_pattern(rand)
    assert tmb.pattern_summary(rand) == (jkept, [len(r) for r in jpattern])
    assert 0.1 < jkept < 0.35


@pytest.mark.parametrize("argv, match", [
    (["--variants", "dense-bf16"], "no counterpart"),
    (["--variants", "sparse-f32,sparse-bf16-nopack"], "no counterpart"),
    (["--variants", "bunch16-sparse"], "no counterpart"),
    (["--ablate"], "--ablate has no counterpart"),
])
def test_microbench_refuses_what_the_kernel_does_not_have(argv, match):
    with pytest.raises(ValueError, match=match):
        tmb.main(argv + ["--device", "cpu"])


def test_microbench_on_the_cpu(capsys):
    got = tmb.main(["--frames", "1", "--chain", "2", "--reps", "1",
                    "--variants", "sparse-f32", "--device", "cpu"])
    r = got["sparse-f32"]
    assert r["bunch"] == 1 and r["sparse"] and r["rtf_device"] is None
    assert r["us_per_sample"] > 0 and r["timed_by"] == "host clock (CPU)"
    out = capsys.readouterr().out
    assert "pattern kept=0.204" in out and "== summary ==" in out


# ---- no JAX in the new modules ----------------------------------------------

NEW_MODULES = [
    "dss_tpu_torch/eval/score_exteval.py",
    "dss_tpu_torch/graft_entry.py",
    "dss_tpu_torch/ops/_host.py",
    "dss_tpu_torch/ops/dsp_synthesis.py",
    "tools/torch_make_import_fixture.py",
    "tools/torch_vocoder_ab.py",
    "tools/torch_bucket_sweep.py",
    "tools/torch_sampler_microbench.py",
]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_dss_tpu(module):
    roots = _imported_roots(REPO / module)
    assert "torch" in roots or "numpy" in roots
    assert not roots & {"jax", "jaxlib", "dss_tpu", "flax", "optax"}, roots

