"""The port's xiph-LPCNet weight interop (dss_tpu_torch/vocoder/interop.py)
against the JAX package's (dss_tpu/vocoder/interop.py), on the CPU.

A foreign checkpoint is built in the upstream Keras layout inside the test
(tests/torch_xiph.py, as tests/test_interop.py builds one): a shared
embedding table, the pitch embedding, reset_after GRUs in (z, r, h) order,
the MDense head with inner biases and factors, GRU-B at 16 as released.
Both packages import it to the same parameters, exactly; their frame nets
agree (atol 1e-5) and so does greedy sampling over two 16-sample frames
(samples atol 1e-5, identical excitations); native exports round-trip
exactly, bunched too, in either direction between the packages; the dict
seam (``params_from_datasets``) equals the file path.
"""

import jax
import numpy as np
import pytest
import torch

from dss_tpu.vocoder import interop as jinterop
from dss_tpu_torch.vocoder import interop as tinterop
from dss_tpu_torch.vocoder import net as tnet

torch.set_num_threads(1)
h5py = pytest.importorskip("h5py")
from torch_xiph import xiph_datasets  # noqa: E402


TINY = dict(gru_a=32, gru_b=16, cond=16, embed=8, pitch=4)


def _foreign_h5(path, seed, **replace):
    """A synthetic checkpoint in the upstream Keras layout, a full-model
    save (the layers under model_weights/): tests/torch_xiph.py's datasets
    at small widths, GRU-B at 16 as released, with ``replace``'s datasets
    in place of its own."""
    with h5py.File(path, "w") as f:
        for name, arr in dict(xiph_datasets(seed, **TINY), **replace).items():
            f.create_dataset(name, data=arr)
    return str(path)


def _assert_same_params(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _assert_same_model(tm, jm):
    for attr in ("gru_a_units", "gru_b_units", "cond_dim", "embed_dim",
                 "bunch"):
        assert getattr(tm, attr) == getattr(jm, attr), attr


def test_foreign_import_matches_jax_exactly(tmp_path):
    """Both packages import the same foreign .h5 to equal parameters, bit
    for bit (shared table fanned out, gates reordered, inner biases and
    factors, the pitch table, a dense GRU-A mask) and the same model."""
    path = _foreign_h5(tmp_path / "foreign.h5", 2)
    tp, tm = tinterop.import_lpcnet_h5(path)
    jp, jm = jinterop.import_lpcnet_h5(path)
    _assert_same_params(tp, jp)
    _assert_same_model(tm, jm)
    assert tm.gru_b_units == 16 and "emb_pitch" in tp
    assert np.any(tp["fc_out1_b"]) and np.all(tp["gru_a_mask"] == 1.0)


def test_params_from_datasets_equals_the_file_path(tmp_path):
    """The dict seam: a file's datasets mapped by ``params_from_datasets``
    give what ``import_lpcnet_h5`` gives; ``datasets_from_params`` is the
    dataset set the JAX exporter writes, byte for byte."""
    path = _foreign_h5(tmp_path / "foreign.h5", 3)
    ds = tinterop.read_datasets(path)
    assert all(k.startswith("model_weights/") for k in ds)
    got, gm = tinterop.params_from_datasets(ds)
    want, wm = tinterop.import_lpcnet_h5(path)
    _assert_same_params(got, want)
    _assert_same_model(gm, wm)
    jpath = str(tmp_path / "jax_export.h5")
    jinterop.export_lpcnet_h5(want, jpath)
    ours = tinterop.datasets_from_params(want)
    theirs = tinterop.read_datasets(jpath)
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_greedy_synthesis_from_imported_params_matches_jax(tmp_path):
    """The imported model through both packages: its frame net (the pitch
    table, same-padded convs) over three frames, atol 1e-5; then greedy
    sampling over two 16-sample frames from that conditioning, the port's
    sampler (its plain version here: fused tables, the inner-bias head,
    GRU-B at 16) against the JAX model's ``sample_step`` scan: samples and
    state atol 1e-5, identical excitations.  Longer free-running runs are
    not compared: an argmax over 256 levels turns a last-bit difference
    into another excitation, which then feeds back."""
    from dss_tpu_torch.ops.sampler import prepare_sampler_weights, \
        sampler_frames

    rng = np.random.default_rng(4)
    path = _foreign_h5(tmp_path / "foreign.h5", 4)
    tp, tm = tinterop.import_lpcnet_h5(path)
    jp, jm = jinterop.import_lpcnet_h5(path)
    jpj = {k: jax.numpy.asarray(v) for k, v in jp.items()}
    tpt = {k: torch.as_tensor(v) for k, v in tp.items()}
    feats = rng.normal(size=(1, 3, 20)).astype(np.float32) * 0.3
    feats[..., 18] = [[0.2, 1.1, -0.6]]   # periods 110, 155 and 70
    cond_t = tm.condition(tpt, torch.as_tensor(feats))
    cond_j = jm.condition(jpj, jax.numpy.asarray(feats))
    np.testing.assert_allclose(cond_t.numpy(), np.asarray(cond_j),
                               atol=1e-5)

    T, F, GA, GB = 2, 16, tm.gru_a_units, tm.gru_b_units
    cond = np.asarray(cond_j)[:, :T]                      # [1, T, 16]
    lpc = (rng.normal(size=(1, T, 16)) * 0.05).astype(np.float32)
    carry0 = (jax.numpy.zeros((1, GA)), jax.numpy.zeros((1, GB)),
              jax.numpy.zeros((1, 16)), jax.numpy.full((1,), 128,
                                                       jax.numpy.int32))
    temp = -jax.numpy.ones((1, 1))
    gumbel = jax.numpy.zeros((1, 256))
    carry, want = carry0, []
    for t in range(T):
        for _ in range(F):
            carry, (sample, _, _) = jm.sample_step(
                jpj, carry, jax.numpy.asarray(cond[:, t]),
                jax.numpy.asarray(lpc[:, t]), gumbel, temp)
            want.append(np.asarray(sample)[0])
    w = prepare_sampler_weights(tpt)
    tcarry = (torch.zeros(1, GA), torch.zeros(1, GB), torch.zeros(1, 16),
              torch.full((1,), 128, dtype=torch.long))
    got_carry, got = sampler_frames(
        w, tcarry, torch.as_tensor(cond).transpose(0, 1).contiguous(),
        torch.as_tensor(lpc).transpose(0, 1).contiguous(),
        -torch.ones((T, 1)), None, F)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got_carry[3].numpy(),
                                  np.asarray(carry[3]))
    for a, b in zip(got_carry[:3], carry[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert float(np.abs(np.asarray(want)).max()) > 0.0


@pytest.mark.parametrize("bunch", [1, 2])
def test_native_export_round_trip_is_exact(tmp_path, bunch):
    """A native checkpoint (per-slot tables, outside bias, GRU-A mask,
    bunched heads at bunch 2) exported by either package and re-imported
    by either gives back the parameters bit for bit and the same model."""
    model = tnet.LPCNetModel(gru_a_units=32, gru_b_units=8, cond_dim=16,
                             embed_dim=8, bunch=bunch)
    params = {k: v.numpy() for k, v in model.init(
        torch.Generator().manual_seed(bunch), device="cpu").items()}
    params["fc_out_b"] = np.random.default_rng(bunch).normal(
        size=256).astype(np.float32)
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    tinterop.export_lpcnet_h5(params, ours)
    jinterop.export_lpcnet_h5(params, theirs)
    for path in (ours, theirs):
        back, m = tinterop.reimport_native_h5(path)
        _assert_same_params(back, params)
        assert m.bunch == bunch and m.gru_a_units == 32
        jback, _ = jinterop.reimport_native_h5(path)
        _assert_same_params(jback, params)
    ds = tinterop.datasets_from_params(params)
    back, _ = tinterop.native_params_from_datasets(ds)
    _assert_same_params(back, params)


def test_foreign_reexport_round_trip(tmp_path):
    """Foreign import -> export -> re-import is the identity (inner biases
    and the pitch table survive)."""
    path = _foreign_h5(tmp_path / "foreign.h5", 5)
    params, _ = tinterop.import_lpcnet_h5(path)
    path2 = str(tmp_path / "reexport.h5")
    tinterop.export_lpcnet_h5(params, path2)
    back, _ = tinterop.reimport_native_h5(path2)
    _assert_same_params(back, params)


def test_reset_before_gru_is_refused(tmp_path):
    """A 1-D GRU bias (reset-before) cannot be mapped exactly: both
    packages refuse it."""
    path = _foreign_h5(tmp_path / "rb.h5", 6, **{
        "model_weights/gru_a/gru_a/bias:0": np.zeros(96, np.float32)})
    with pytest.raises(ValueError, match="reset_after"):
        tinterop.import_lpcnet_h5(path)
    with pytest.raises(ValueError, match="reset_after"):
        jinterop.import_lpcnet_h5(path)
