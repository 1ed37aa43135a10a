"""The port's ``dss_tpu_torch/graft_entry.py`` against __graft_entry__.py on
the CPU.

* ``entry()``: the flagship decoder's forward step (2 x 100, 64
  electrodes) on the JAX entry's parameters, carried over by
  ``convert.lstm_state_dict``, equals the JAX forward on a seeded segment
  within atol 1e-5 (float32 LSTM sums in another order);
* ``dryrun_multichip(2)`` over two spawned gloo ranks (tests/torch_dist.py:
  a FileStore in the test's directory, a timeout on the spawn; the mesh is
  1 x 2, gate-parallel): all seven steps run and assert on each rank, and
  their losses are finite and equal on both ranks;
* ``python -m dss_tpu_torch.graft_entry --device cpu`` at world 1 prints
  the forward's shape and every step's "ok" line.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist  # noqa: E402

from dss_tpu_torch import graft_entry  # noqa: E402
from dss_tpu_torch.convert import lstm_state_dict  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
torch.set_num_threads(1)

import __graft_entry__ as jentry  # noqa: E402

STEPS = ("decoder train step ok", "vad tbptt step ok",
         "dp vocoder train step ok", "sharded vocoder serving ok",
         "fused word path ok", "graph serving ok",
         "distinct-slot chunked serving ok")


def test_entry_forward_matches_jax():
    jfn, (jparams, jseg) = jentry.entry()
    forward, (model, segment) = graft_entry.entry("cpu")
    assert tuple(segment.shape) == tuple(jseg.shape) == (1, 100, 64)
    assert model.nb_layer == 2 and model.nb_hidden_units == 100 and \
        model.nb_electrodes == 64
    model.load_state_dict(lstm_state_dict(
        jax.tree_util.tree_map(np.asarray, jparams), "regressor"))
    x = np.random.default_rng(0).normal(size=(1, 100, 64)).astype(np.float32)
    want = np.asarray(jax.jit(jfn)(jparams, jnp.asarray(x)))
    got = forward(model, torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (1, 100, 20)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return torch_dist.spawn(torch_dist.graft_dryrun, 2,
                            tmp_path_factory.mktemp("graft"), 2)


def test_dryrun_at_world_2_over_gloo(world2):
    r0, r1 = world2
    assert r0["mesh"] == r1["mesh"] == (1, 2)
    for key in ("decoder_loss", "vad_loss", "vocoder_loss"):
        assert np.isfinite(r0[key]) and r0[key] == r1[key], key
    assert r0["serving_pcm_shape"] == (1, 320)
    assert r0["word_path_shapes"] == ((1, 4, 20), (1, 640))
    assert r0["graph_shapes"] == ((3, 20), (480,))
    assert r0["chunked"] == {"head": 8000, "tails": 1, "slots": 2}
    assert "graph_shapes" not in r1 and "chunked" not in r1


def test_module_runs_entry_and_the_dryrun_at_world_1():
    out = subprocess.run(
        [sys.executable, "-m", "dss_tpu_torch.graft_entry", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "entry forward: (1, 100, 20)"
    for step in STEPS:
        assert any(line.startswith("dryrun_multichip(1): " + step)
                   for line in lines), step
    assert lines[-1].startswith("dryrun_multichip(1): ok, loss=")
