"""The port's scale-out (dss_tpu_torch/parallel) against the JAX package's
(dss_tpu/parallel, on the 8-device virtual CPU mesh) and against one
process, on the CPU: the counterpart of tests/test_parallel.py.

One spawn of four gloo ranks (a 2 x 2 data x model mesh, the workers in
tests/torch_dist.py) runs every multi-rank case once; the tests below read
its saved results.  Tolerances: the gate-parallel forward and the DP
gradients sum in other orders than one process (atol 1e-5, the JAX test's);
losses rtol 1e-5; the word path's features against JAX atol 1e-4.  A
shard's noise is the whole batch's, bit for bit; the sharded word path's
audio equals one process's at atol 1e-5, not bit for bit, because the
packed LSTM on the CPU rounds a row differently in a batch of 4 than of 8
(~4e-8)."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dss_tpu.models import BidirectionalSpeechSynthesisModel as JDec
from dss_tpu.parallel import make_mesh as jax_make_mesh
from dss_tpu.parallel import shard_lstm_params as jax_shard_lstm_params
from dss_tpu.parallel import sharded_fused_word_path as jax_word_path
from dss_tpu.vocoder import net as jnet
from dss_tpu_torch.convert import lstm_state_dict, vocoder_params
from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
from dss_tpu_torch.models.lstm import seeded_init
from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector
from dss_tpu_torch.parallel import batched_vocoder_sharding, make_mesh
from dss_tpu_torch.parallel.mesh import mesh_shape
from dss_tpu_torch.models.decoder import hold_last_frame
from dss_tpu_torch.parallel.shard import lstm_block_state_dict
from dss_tpu_torch.train.trainer_decoder import DecoderTrainer
from dss_tpu_torch.train.trainer_vad import VadTrainer
from dss_tpu_torch.train.trainer_vocoder import VocoderTrainer
from dss_tpu_torch.vocoder import net as tnet

import torch_dist

torch.set_num_threads(1)
E, H = 6, 8          # electrodes and hidden units of the small models
SEG_E = 8            # the word path's electrodes


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The cases' inputs, made from seeds with numpy and JAX's inits."""
    rng = np.random.default_rng(0)
    inp = {"hidden": np.int64(H)}
    # Gate-parallel forward: the JAX decoder's parameters, unequal lengths.
    jdec = JDec(2, H, E, nb_outputs=4)
    jparams = _np(jdec.init(jax.random.PRNGKey(0)))
    for k, v in lstm_state_dict(jparams, "regressor").items():
        inp[f"dec.{k}"] = v.numpy()
    inp["fwd_x"] = rng.normal(size=(8, 20, E)).astype(np.float32)
    inp["fwd_len"] = np.array([20, 13, 7, 20, 1, 18, 11, 20])
    # DP steps: the valid counts differ between the data shards.
    lengths = np.array([50, 12, 33, 50, 5, 41, 27, 50])
    inp["dec_x"] = rng.normal(size=(8, 50, E)).astype(np.float32)
    inp["dec_y"] = rng.normal(size=(8, 50, 20)).astype(np.float32)
    inp["dec_mask"] = (np.arange(50)[None] < lengths[:, None]).astype(
        np.float32)
    # One 50-frame chunk with an update, one with no valid frame anywhere.
    vad_len = np.array([50, 17, 8, 34])
    inp["vad_x"] = rng.normal(size=(4, 100, E)).astype(np.float32)
    inp["vad_y"] = (rng.random((4, 100)) > 0.5).astype(np.float32)
    inp["vad_mask"] = (np.arange(100)[None] < vad_len[:, None]).astype(
        np.float32)
    inp["voc_feats"] = (rng.normal(size=(8, 2, 20)) * 0.1).astype(np.float32)
    inp["voc_sig"] = (rng.normal(size=(8, 320)) * 0.05).astype(np.float32)
    # The word path: 8 slots of distinct lengths on a small vocoder.
    wp = JDec(2, H, SEG_E)
    wparams = _np(wp.init(jax.random.PRNGKey(3)))
    for k, v in lstm_state_dict(wparams, "regressor").items():
        inp[f"wp.{k}"] = v.numpy()
    vm = jnet.LPCNetModel(gru_a_units=16, gru_b_units=8, cond_dim=8,
                          embed_dim=8)
    vparams = _np(vm.init(jax.random.PRNGKey(4)))
    for k, v in vparams.items():
        inp[f"voc.{k}"] = v
    seg_len = np.array([6, 3, 5, 6, 2, 4, 6, 1])
    inp["seg"] = rng.normal(size=(8, 6, SEG_E)).astype(np.float32)
    inp["seg_mask"] = (np.arange(6)[None] < seg_len[:, None]).astype(
        np.float32)
    path = tmp_path_factory.mktemp("parallel") / "inputs.npz"
    np.savez(path, **inp)
    return dict(path=path, jparams=jparams, wparams=wparams, vm=vm,
                vparams=vparams, **inp)


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    """Every multi-rank case, once, on four gloo ranks (2 x 2)."""
    return torch_dist.spawn(torch_dist.parallel_cases, 4,
                            tmp_path_factory.mktemp("world4"),
                            str(inputs["path"]))


def _by_coord(results, key, model=0):
    """Results of ``key`` in data-coordinate order, from the ranks at model
    coordinate ``model``."""
    ranks = sorted((r for r in results if r["model"] == model),
                   key=lambda r: r["data"])
    return [r[key] for r in ranks]


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    data, model = mesh_shape(n)
    assert jax_make_mesh(n).shape == {"data": data, "model": model}
    assert jax_make_mesh(n, model_parallel=1).shape == \
        dict(zip(("data", "model"), mesh_shape(n, 1)))


def test_make_mesh_world_one_and_torchrun_message():
    """make_mesh(1) starts its own world-1 gloo group; a larger mesh with
    no process group names torchrun."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(2, device="cpu")
    try:
        mesh = make_mesh(1, device="cpu")
        assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("data",
                                                                 "model")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        with pytest.raises(ValueError, match="torchrun"):
            make_mesh(4, device="cpu")
    finally:
        dist.destroy_process_group()


def test_world4_mesh(world4):
    assert all(r["shape"] == (2, 2) for r in world4)
    assert sorted((r["data"], r["model"]) for r in world4) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_shard_shapes_match_jax(world4):
    """Gate tensors [4H, ...] split over the model axis as JAX places
    them, the head replicated (H = 100, E = 64: (200, 64))."""
    params = JDec(2, 100, 64).init(jax.random.PRNGKey(0))
    sharded = jax_shard_lstm_params(jax_make_mesh(8), params, 100)
    w = sharded["lstm"][0][0]["w_ih"]
    head = sharded["regressor"]["weight"]
    for r in world4:
        s = r["shard_shapes"]
        assert s["lstm.weight_ih_l0"] == w.sharding.shard_shape(w.shape) \
            == (200, 64)
        assert s["lstm.weight_hh_l1_reverse"] == (200, 100)
        assert s["lstm.bias_ih_l0"] == (200,)
        assert s["regressor.weight"] == head.sharding.shard_shape(
            head.shape) == (20, 200)


def test_lstm_block_state_dict_takes_port_and_jax_params(inputs):
    """A rank's blocks from the port's state_dict equal those from the JAX
    pytree, and the blocks of all ranks concatenate to the whole."""
    sd = lstm_state_dict(inputs["jparams"], "regressor")
    blocks = [lstm_block_state_dict(inputs["jparams"], H, i, 2)
              for i in range(2)]
    for k, v in sd.items():
        assert torch.equal(lstm_block_state_dict(sd, H, 1, 2)[k],
                           blocks[1][k])
        whole = torch.cat([b[k] for b in blocks]) if v.shape[0] == 4 * H \
            else blocks[0][k]
        assert torch.equal(whole, v)


def test_gate_parallel_forward_matches_jax(inputs, world4):
    """The gate-parallel decoder (2 x 2 mesh) equals the JAX forward with
    the same parameters on every position, the padded ones included (both
    hold (h, c) over masked steps)."""
    x, lengths = inputs["fwd_x"], inputs["fwd_len"]
    mask = (np.arange(20)[None] < lengths[:, None]).astype(np.float32)
    want, _ = JDec(2, H, E, nb_outputs=4).apply(inputs["jparams"], x, None,
                                                mask=mask)
    for model in (0, 1):
        got = np.concatenate(_by_coord(world4, "forward", model))
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def _grads(model):
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


def _assemble(world4, key):
    """The sharded gradients put back together: the gate rows of the two
    model ranks (of data rank 0) in order; both data ranks must agree."""
    out = {}
    for model in (0, 1):
        a, b = _by_coord(world4, key, model)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    g0, g1 = (_by_coord(world4, key, m)[0] for m in (0, 1))
    for k in g0:
        out[k] = np.concatenate([g0[k], g1[k]]) \
            if k.startswith("lstm.") else g0[k]
        if not k.startswith("lstm."):
            np.testing.assert_array_equal(g0[k], g1[k])
    return out


def test_dp_decoder_step_matches_one_process(inputs, world4):
    """The 2 x 2 decoder step's loss and gradients equal one process's
    step on the whole batch, though the data shards hold different
    numbers of valid frames."""
    model = BidirectionalSpeechSynthesisModel(2, H, E)
    seeded_init(model, 0)
    tr = DecoderTrainer(model, device="cpu")
    loss = float(tr.train_step(inputs["dec_x"], inputs["dec_y"],
                               inputs["dec_mask"]))
    assert len({r["dec_loss"] for r in world4}) == 1
    np.testing.assert_allclose(world4[0]["dec_loss"], loss, rtol=1e-5)
    got, want = _assemble(world4, "dec_grads"), _grads(tr.model)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_dp_vad_step_matches_one_process(inputs, world4):
    """The 2 x 2 nVAD TBPTT trial: the same mean chunk loss and last
    update's gradients as one process; the all-padding chunk updates
    nothing on any rank."""
    model = UnidirectionalVoiceActivityDetector(2, H, E)
    seeded_init(model, 0)
    tr = VadTrainer(model, device="cpu")
    loss = float(tr.tbptt_trial(inputs["vad_x"], inputs["vad_y"],
                                inputs["vad_mask"]))
    assert len({r["vad_loss"] for r in world4}) == 1
    np.testing.assert_allclose(world4[0]["vad_loss"], loss, rtol=1e-5)
    got, want = _assemble(world4, "vad_grads"), _grads(tr.model)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_dp_vocoder_step_matches_one_process(inputs, world4):
    """Data-parallel vocoder training at the shipped width: the loss and
    the gru_a_wh gradient the update applies equal one process's over the
    whole batch (the JAX test's tolerances)."""
    tr = VocoderTrainer(tnet.LPCNetModel(), learning_rate=1e-3,
                        noise_level=0, device="cpu")
    params = tr.init()
    loss = tr._loss(params, torch.as_tensor(inputs["voc_feats"]),
                    torch.as_tensor(inputs["voc_sig"]))
    grad, = torch.autograd.grad(loss, [params["gru_a_wh"]])
    loss = float(loss.detach())
    for r in world4:
        np.testing.assert_allclose(r["voc_loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["voc_grad_gru_a_wh"], grad.numpy(),
                                   atol=1e-5)


def test_sharded_word_path_matches_jax_and_one_process(inputs, world4):
    """The word path over the 2 x 2 mesh: its decoded features equal the
    JAX package's sharded word path on the 8-device mesh on every valid
    frame (atol 1e-4), and its features and audio equal one process's
    (atol 1e-5)."""
    seg, masks = inputs["seg"], inputs["seg_mask"]
    lengths = masks.sum(axis=1).astype(np.int64)
    lpc = world4[0]["word_lpc"]
    for r in world4[1:]:
        np.testing.assert_array_equal(r["word_lpc"], lpc)
        np.testing.assert_array_equal(r["word_pcm"], world4[0]["word_pcm"])
    want_lpc, _ = jax_word_path(
        jax_make_mesh(8), seg, masks, JDec(2, H, SEG_E), inputs["wparams"],
        inputs["vm"], inputs["vparams"], jnet.net_vocoder_init(inputs["vm"],
                                                               8))
    assert lpc.shape == want_lpc.shape == (8, 6, 20)
    for i, T in enumerate(lengths):
        np.testing.assert_allclose(lpc[i, :T], want_lpc[i, :T], atol=1e-4)

    dec = BidirectionalSpeechSynthesisModel(2, H, SEG_E)
    dec.load_state_dict(lstm_state_dict(inputs["wparams"], "regressor"))
    voc = vocoder_params(inputs["vparams"])
    vm = tnet.LPCNetModel.from_params(voc)
    with torch.no_grad():
        pred, _ = dec(torch.as_tensor(seg), lengths=lengths)
        pcm, _ = tnet.net_synthesize_frames(
            vm, voc, tnet.net_vocoder_init(vm, 8, device="cpu"),
            hold_last_frame(pred, lengths))
    # The packed LSTM rounds a row differently in a batch of 4 than of 8
    # (~4e-8 here), so the audio is held at atol 1e-5, not bit for bit.
    for i, T in enumerate(lengths):
        np.testing.assert_allclose(lpc[i, :T], pred[i, :T].numpy(),
                                   atol=1e-5)
    np.testing.assert_allclose(world4[0]["word_pcm"], pcm.numpy(), atol=1e-5)
    assert world4[0]["word_pcm"].shape == (8, 6 * 160)


def test_shard_noise_is_the_batch_noise_slice():
    """A shard's Gumbel noise is its rows of the whole batch's, bit for
    bit, wherever the shard lies; the state of a shard records where."""
    whole = tnet.gumbel_noise(11, 40, 3, 8, "cpu")
    for lo, n in ((0, 4), (4, 4), (2, 2), (7, 1), (0, 8)):
        part = tnet.gumbel_noise(11, 40, 3, n, "cpu", slot_lo=lo, slots=8)
        assert torch.equal(part, whole[:, :, lo:lo + n])
    with pytest.raises(ValueError, match="outside"):
        tnet.gumbel_noise(11, 40, 3, 4, "cpu", slot_lo=6, slots=8)


def test_sharded_vocoder_state_draws_its_slots_noise():
    """Through net_synthesize_frames: slots 4..7 of an 8-stream batch,
    vocoded alone from a sharded state, give the batch's audio for those
    slots bit for bit (the noise of slot 4 of 8 is not that of slot 0 of
    4)."""
    model = tnet.LPCNetModel(gru_a_units=16, gru_b_units=8, cond_dim=8,
                             embed_dim=8)
    params = model.init(torch.Generator().manual_seed(5), "cpu")
    feats = torch.as_tensor(np.random.default_rng(6).normal(
        size=(8, 3, 20)).astype(np.float32) * 0.3)
    state = tnet.net_vocoder_init(model, 8, seed=2, device="cpu")
    whole, _ = tnet.net_synthesize_frames(model, params, state, feats)
    rows = {k: (v[4:] if isinstance(v, torch.Tensor) else v)
            for k, v in state._asdict().items()}
    shard = tnet.NetVocoderState(**{**rows, "slot_lo": 4, "slots": 8})
    part, after = tnet.net_synthesize_frames(model, params, shard, feats[4:])
    assert torch.equal(part, whole[4:])
    assert (after.slot_lo, after.slots) == (4, 8)
    unsharded, _ = tnet.net_synthesize_frames(
        model, params, tnet.net_vocoder_init(model, 4, seed=2, device="cpu"),
        feats[4:])
    assert not torch.equal(unsharded, whole[4:])


def test_batched_vocoder_sharding_at_world_one():
    """At world 1 the whole batch is the shard: every tensor unchanged and
    the state marked as slots 0.. of the batch."""
    try:
        mesh = make_mesh(1, device="cpu")
        model = tnet.LPCNetModel(gru_a_units=16, gru_b_units=8, cond_dim=8,
                                 embed_dim=8, bunch=2)
        state = tnet.net_vocoder_init(model, 4, device="cpu")
        feats = np.zeros((4, 2, 20), np.float32)
        local, x = batched_vocoder_sharding(mesh, state, feats)
        assert (local.slot_lo, local.slots) == (0, 4)
        assert local.exc_idx.shape == (4, 2) and x.shape == (4, 2, 20)
        for a, b in zip(local[:6], state[:6]):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
