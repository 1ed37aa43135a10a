"""Parity of the port's bunched vocoder (bunch S in {2, 4, 8}) with the JAX
package, on the CPU (the port's bunched sampler runs its plain version
here).

As in tests/test_torch_vocoder.py the autoregressive loop is compared
teacher-forced, or free-running over at most two tiny frames.  The JAX
Pallas bunched sampler runs in interpret mode, greedy, with f32 weights,
as tests/test_bunched.py runs it.
"""

import os

os.environ["DSS_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dss_tpu.vocoder import net as jnet  # noqa: E402
from dss_tpu_torch.convert import vocoder_params  # noqa: E402
from dss_tpu_torch.ops import sampler as tsamp  # noqa: E402
from dss_tpu_torch.vocoder import net as tnet  # noqa: E402

torch.set_num_threads(1)
TINY = dict(gru_a_units=16, gru_b_units=8, cond_dim=8, embed_dim=8)
WEIGHTS = os.path.join(os.path.dirname(__file__), "..", "weights")
SHIPPED = {"vocoder_speech.npz": 1, "vocoder_speech_b2.npz": 2,
           "vocoder_speech_b4.npz": 4, "vocoder_speech_b8.npz": 8,
           "vocoder_synthetic.npz": 1, "vocoder_synthetic_b2.npz": 2,
           "vocoder_synthetic_b4.npz": 4}


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _model(S, seed=0, inner_bias=False, **sizes):
    """(JAX model, numpy params, port model, port params) at bunch S."""
    sizes = sizes or TINY
    jm = jnet.LPCNetModel(bunch=S, **sizes)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    # init() leaves every bias at zero and every gain at one: randomize
    # them, or a swapped head would go unseen.
    for k in list(jp):
        if k.startswith("fc_out") and ("_g" in k or k.startswith("fc_out_b")):
            jp[k] = jp[k] + rng.normal(size=jp[k].shape).astype(np.float32) * 0.2
    if inner_bias:
        for j in range(S):
            sfx = "" if j == 0 else f"_b{j}"
            for n in (1, 2):
                jp[f"fc_out{n}_b{sfx}"] = \
                    rng.normal(size=256).astype(np.float32) * 0.3
    return jm, jp, tnet.LPCNetModel(bunch=S, **sizes), vocoder_params(jp)


def _features(rng, B, T):
    f = rng.normal(size=(B, T, 20)).astype(np.float32) * 0.3
    f[..., 0] += -6.0
    f[..., 18] = rng.uniform(-0.5, 0.5, size=(B, T))
    f[..., 19] = rng.uniform(-0.5, 0.5, size=(B, T))
    return f


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_from_params_loads_every_shipped_checkpoint(name):
    """LPCNetModel.from_params reads the bunch of each of the seven shipped
    checkpoints from its per-lag tables, as the JAX package does; the
    fresh state's excitation history is [B] at bunch 1 and [B, S] at S;
    the prepared sampler weights have the shapes the kernels take."""
    with np.load(os.path.join(WEIGHTS, name)) as f:
        raw = {k: f[k] for k in f.files}
    tp = vocoder_params(raw)
    tm = tnet.LPCNetModel.from_params(tp)
    jm = jnet.LPCNetModel.from_params(raw)
    S = SHIPPED[name]
    assert tm.bunch == jm.bunch == S
    assert (tm.gru_a_units, tm.gru_b_units, tm.cond_dim, tm.embed_dim) == \
        (jm.gru_a_units, jm.gru_b_units, jm.cond_dim, jm.embed_dim)
    st = tnet.net_vocoder_init(tm, batch=3, device="cpu")
    jst = jnet.net_vocoder_init(jm, batch=3)
    assert tuple(st.exc_idx.shape) == tuple(jst.exc_idx.shape) == \
        ((3,) if S == 1 else (3, S))
    assert int(st.exc_idx.min()) == int(st.exc_idx.max()) == 128
    w = tnet.sampler_weights_for(tm, tp)
    ga = tm.gru_a_units
    assert w["emb"].shape == (2 * S + 1, 256, 3 * ga)
    assert w["w_out"].shape == (tm.gru_b_units, S * 512)
    assert w["b_out"].shape == (S * 256,)
    assert w["wx_a_cond"].shape == (tm.cond_dim, 3 * ga)
    if S > 1:
        assert w["corr"].shape == (S - 1, 2, 256, 256)


def test_model_rejects_a_bunch_that_does_not_divide_the_frame():
    with pytest.raises(ValueError):
        tnet.LPCNetModel(bunch=3)
    with pytest.raises(ValueError):
        tsamp.prepare_bunched_sampler_weights(_model(1)[3])


def test_vocoder_params_round_trips_every_key_of_b8():
    """convert.vocoder_params keeps every key, shape, dtype and value of
    the shipped b8 checkpoint (per-lag tables, per-sub-sample heads and
    correction embeddings included)."""
    with np.load(os.path.join(WEIGHTS, "vocoder_speech_b8.npz")) as f:
        raw = {k: f[k] for k in f.files}
    tp = vocoder_params(raw)
    assert set(tp) == set(raw)
    for j in range(1, 8):
        for key in (f"emb_sig_l{j}", f"emb_exc_l{j}", f"fc_out1_w_b{j}",
                    f"fc_out2_g_b{j}", f"fc_out_b_b{j}",
                    f"bunch_exc_emb_b{j}", f"bunch_pred_emb_b{j}"):
            assert key in tp
    for k, v in raw.items():
        assert tuple(tp[k].shape) == v.shape
        np.testing.assert_array_equal(tp[k].numpy(), v)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("inner_bias", [False, True])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_bunch_step_teacher_forced_matches_jax(rng, S, inner_bias, B):
    """LPCNetModel.bunch_step, teacher-forced with injected noise, over
    stochastic and greedy rows: identical excitations, samples and carries
    within 1e-5 (f32 products in two libraries)."""
    jm, jp, tm, tp = _model(S, seed=S, inner_bias=inner_bias)
    for _ in range(3):
        carry = (rng.normal(size=(B, 16)).astype(np.float32) * 0.5,
                 rng.normal(size=(B, 8)).astype(np.float32) * 0.5,
                 rng.uniform(-0.3, 0.3, size=(B, 16)).astype(np.float32),
                 rng.integers(0, 256, size=(B, S)).astype(np.int32))
        cond = rng.normal(size=(B, 8)).astype(np.float32)
        lpc = rng.normal(size=(B, 16)).astype(np.float32) * 0.1
        gumbel = rng.gumbel(size=(B, S, 256)).astype(np.float32)
        temp = np.array([[1.3], [-1.0], [2.0]], np.float32)[:B]
        cj, (sj, ej) = jm.bunch_step(_j(jp), tuple(map(jnp.asarray, carry)),
                                     cond, lpc, gumbel, temp)
        ct, (st, et) = tm.bunch_step(
            tp, (_t(carry[0]), _t(carry[1]), _t(carry[2]),
                 _t(carry[3], torch.long)),
            _t(cond), _t(lpc), _t(gumbel), _t(temp))
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
        for a, b in zip(ct[:3], cj[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        np.testing.assert_array_equal(ct[3].numpy(), np.asarray(cj[3]))
        assert tuple(ct[3].shape) == (B, S)


def _pallas_vs_plain(jm, jp, tp, S, B, T, F, rng, pattern=None):
    import dss_tpu.ops.pallas.sampler as jsamp

    ga, gb, cd = jm.gru_a_units, jm.gru_b_units, jm.cond_dim
    cond = rng.normal(size=(B, T, cd)).astype(np.float32) * 0.5
    lpc = rng.normal(size=(B, T, 16)).astype(np.float32) * 0.05
    temp = -np.ones((B, T, 1), np.float32)
    carry0 = (np.zeros((B, ga), np.float32), np.zeros((B, gb), np.float32),
              rng.uniform(-0.1, 0.1, size=(B, 16)).astype(np.float32),
              rng.integers(0, 256, size=(B, S)).astype(np.int32))
    jc, jsig = jsamp.sampler_frames_bunched_pallas(
        jm, _j(jp), tuple(map(jnp.asarray, carry0)), jnp.asarray(cond),
        jnp.asarray(lpc), jnp.asarray(temp),
        seeds=jnp.arange(T, dtype=jnp.int32), frame_size=F, stochastic=False,
        weight_dtype=jnp.float32, sparse_pattern=pattern)
    w = tsamp.prepare_bunched_sampler_weights(tp)
    tc, tsig = tsamp.sampler_frames_bunched(
        w, (_t(carry0[0]), _t(carry0[1]), _t(carry0[2]),
            _t(carry0[3], torch.long)),
        _t(cond).transpose(0, 1).contiguous(),
        _t(lpc).transpose(0, 1).contiguous(),
        _t(temp[..., 0]).transpose(0, 1).contiguous(), None, F)
    np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), atol=1e-5)
    for a, b in zip(tc[:3], jc[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_array_equal(tc[3].numpy(), np.asarray(jc[3]))
    assert tuple(tc[3].shape) == (B, S)


@pytest.mark.parametrize("B", [1, 2, 8])
@pytest.mark.parametrize("S", [2, 4])
def test_bunched_plain_matches_jax_pallas_interpret(rng, monkeypatch, S, B):
    """The port's bunched sampler (plain version on the CPU) vs the JAX
    Pallas bunched kernel in interpret mode: greedy, stochastic=False, f32
    weights, tiny widths, two 16-sample frames, a random carried history.
    B = 8 runs the TPU kernel's one-hot path, B <= 4 its row gathers.
    atol 1e-5; identical excitation history."""
    import dss_tpu.ops.pallas.sampler as jsamp

    monkeypatch.setattr(jsamp, "_INTERPRET", True)
    jm, jp, _, tp = _model(S, seed=10 + S, inner_bias=(B == 2))
    _pallas_vs_plain(jm, jp, tp, S, B, 2, 16, rng)


def test_bunched_plain_matches_jax_pallas_tile_sparse_full_width(
        rng, monkeypatch):
    """The same at full width (GRU-A 384, GRU-B 32, cond 128), bunch 2,
    with a tile-sparse GRU-A mask as tests/test_bunched.py builds it: the
    TPU kernel reads only the kept [16 x 128] tiles, the port multiplies
    by the mask.  One 16-sample frame; atol 1e-5."""
    import dss_tpu.ops.pallas.sampler as jsamp

    monkeypatch.setattr(jsamp, "_INTERPRET", True)
    full = dict(gru_a_units=384, gru_b_units=32, cond_dim=128, embed_dim=128)
    jm, jp, _, _ = _model(2, seed=0, **full)
    keep = (np.random.default_rng(5).random((24, 9)) < 0.3)
    keep[:4] = True
    mask = np.repeat(np.repeat(keep.astype(np.float32), 16, 0), 128, 1)
    pattern, kept = jsamp.tile_sparse_pattern(mask)
    assert kept < 1.0
    assert tsamp.tile_sparse_pattern(mask) == (pattern, kept)
    jp = dict(jp, gru_a_mask=mask)
    _pallas_vs_plain(jm, jp, vocoder_params(jp), 2, 1, 1, 16, rng,
                     pattern=pattern)


def _port_noise_from_jax(jst, T, B, S):
    """The JAX scan path's bunched Gumbel noise ([T, F/S, B, S, 256] from
    the fold_in(rng, frame) keys) in the port's layout [T, 160, B, 256]:
    sub-sample j of step i sits at position i*S + j."""
    keys = jax.vmap(lambda t: jax.random.fold_in(jst.rng, t))(
        jnp.arange(T, dtype=jnp.int32))
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (160 // S, B, S, 256), jnp.float32))(keys))
    return g.transpose(0, 1, 3, 2, 4).reshape(T, 160, B, 256)


@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_bunched_net_synthesize_frames_matches_jax_scan(rng, S, greedy):
    """net_synthesize_frames at bunch S over two tiny frames vs the JAX
    scan path: greedy, and stochastic with the JAX noise injected in the
    port's layout.  atol 1e-5 on PCM and state; identical history."""
    jm, jp, tm, tp = _model(S, seed=20 + S)
    B, T, seed = 2, 2, 11
    feats = _features(rng, B, T)
    jst = jnet.net_vocoder_init(jm, batch=B, seed=seed)
    pcm_j, jst2 = jnet.net_synthesize_frames(
        jm, _j(jp), jst, jnp.asarray(feats), greedy=greedy,
        quiet_sharpen=True)
    tst = tnet.net_vocoder_init(tm, batch=B, seed=seed, device="cpu")
    pcm_t, tst2 = tnet.net_synthesize_frames(
        tm, tp, tst, _t(feats), greedy=greedy, quiet_sharpen=True,
        gumbel=None if greedy else _t(_port_noise_from_jax(jst, T, B, S)))
    np.testing.assert_allclose(pcm_t.numpy(), np.asarray(pcm_j), atol=1e-5)
    np.testing.assert_allclose(tst2.h_a.numpy(), np.asarray(jst2.h_a),
                               atol=1e-5)
    np.testing.assert_array_equal(tst2.exc_idx.numpy(),
                                  np.asarray(jst2.exc_idx))
    np.testing.assert_allclose(tst2.deemph.numpy(), np.asarray(jst2.deemph),
                               atol=1e-5)
    assert tst2.frame_ctr == T and tuple(tst2.exc_idx.shape) == (B, S)


def test_bunched_chunked_equals_single_shot(rng):
    """At bunch 4, two 50-frame calls give exactly the audio and state of
    one 100-frame call (the COND_BLOCK discipline and noise keyed by the
    absolute frame), on the plain bunched sampler."""
    _, _, tm, tp = _model(4, seed=3)
    feats = _t(_features(rng, 1, 100))
    w = tnet.sampler_weights_for(tm, tp)
    st = tnet.net_vocoder_init(tm, batch=1, seed=4, device="cpu")
    kw = dict(quiet_sharpen=True, sampler_weights=w)
    whole, s_whole = tnet.net_synthesize_frames(tm, tp, st, feats, **kw)
    p1, s1 = tnet.net_synthesize_frames(tm, tp, st, feats[:, :50], **kw)
    p2, s2 = tnet.net_synthesize_frames(tm, tp, s1, feats[:, 50:], **kw)
    assert torch.equal(torch.cat([p1, p2], dim=1), whole)
    assert torch.equal(s2.h_a, s_whole.h_a)
    assert torch.equal(s2.exc_idx, s_whole.exc_idx)
    assert s2.frame_ctr == s_whole.frame_ctr == 100
    assert float(whole.abs().max()) <= 1.0


def test_noise_of_a_stream_does_not_depend_on_the_bunch(rng, monkeypatch):
    """The sampler is handed the same noise tensor at bunch 1, 2 and 8:
    [T, 160, B, 256] keyed by (seed, absolute frame, position)."""
    seen = {}
    feats = _t(_features(rng, 2, 3))
    for S in (1, 2, 8):
        _, _, tm, tp = _model(S)
        name = "sampler_frames_bunched" if S > 1 else "sampler_frames"
        real = getattr(tsamp, name)

        def spy(w, carry, cond, lpc, temp, noise, F, real=real, S=S):
            seen[S] = noise
            return real(w, carry, cond, lpc, temp, noise, F)

        monkeypatch.setattr(tsamp, name, spy)
        st = tnet.net_vocoder_init(tm, batch=2, seed=9, device="cpu")
        st = st._replace(frame_ctr=7)
        tnet.net_synthesize_frames(tm, tp, st, feats)
        monkeypatch.setattr(tsamp, name, real)
    assert tuple(seen[1].shape) == (3, 160, 2, 256)
    assert torch.equal(seen[1], seen[2]) and torch.equal(seen[1], seen[8])
    assert torch.equal(seen[1], tnet.gumbel_noise(9, 7, 3, 2, "cpu"))


def _with_pitch_embedding(jm, jp, rng, pitch_dim=4):
    """An imported-style checkpoint: an ``emb_pitch`` table, and a first
    conv that takes the 20 features plus the embedded period."""
    jp = dict(jp)
    jp["emb_pitch"] = rng.normal(size=(256, pitch_dim)).astype(np.float32)
    jp["conv1_w"] = (rng.normal(size=(3 * (20 + pitch_dim), jm.cond_dim))
                     .astype(np.float32) * 0.2)
    return jp


def test_condition_with_pitch_embedding_matches_jax(rng):
    """The same-padded frame network of an ``emb_pitch`` checkpoint
    (period index from feature 18, convs that see one future frame each)
    against JAX; atol 1e-5.  It differs from the causal network on the
    same features."""
    jm, jp, tm, _ = _model(1, seed=5)
    jp = _with_pitch_embedding(jm, jp, rng)
    tp = vocoder_params(jp)
    feats = _features(rng, 2, 9)
    feats[0, 0, 18], feats[0, 1, 18] = -3.0, 4.0  # clipped period indices
    want = np.asarray(jm.condition(_j(jp), jnp.asarray(feats)))
    got = tm.condition(tp, _t(feats)).numpy()
    assert got.shape == (2, 9, 8)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # Same-padding looks ahead: changing the last frame moves earlier rows.
    feats2 = feats.copy()
    feats2[:, -1, :18] += 1.0
    got2 = tm.condition(tp, _t(feats2)).numpy()
    assert np.abs(got2[:, -3] - got[:, -3]).max() > 1e-4
    np.testing.assert_array_equal(got2[:, :-3], got[:, :-3])


def test_pitch_embedding_checkpoints_run_single_shot(rng, monkeypatch):
    """An ``emb_pitch`` checkpoint runs the whole call as one block (its
    conditioning looks ahead, so 50-frame boundaries would change it):
    the sampler sees one 60-frame call; a two-frame greedy call agrees
    with the JAX scan path (atol 1e-5); and from_params takes such a
    checkpoint."""
    jm, jp, _, _ = _model(1, seed=6)
    jp = _with_pitch_embedding(jm, jp, rng)
    tp = vocoder_params(jp)
    tm = tnet.LPCNetModel.from_params(tp)
    assert tm.bunch == 1
    feats = _features(rng, 1, 60)
    calls = []
    real = tsamp.sampler_frames

    def spy(w, carry, cond, *rest):
        calls.append(cond.shape[0])
        return real(w, carry, cond, *rest)

    monkeypatch.setattr(tsamp, "sampler_frames", spy)
    pcm, st = tnet.net_synthesize_frames(
        tm, tp, tnet.net_vocoder_init(tm, 1, device="cpu"), _t(feats),
        greedy=True)
    monkeypatch.setattr(tsamp, "sampler_frames", real)
    assert calls == [60] and pcm.shape == (1, 60 * 160)
    assert st.frame_ctr == 60 and bool(torch.isfinite(pcm).all())
    pcm_j, _ = jnet.net_synthesize_frames(
        jm, _j(jp), jnet.net_vocoder_init(jm, 1), jnp.asarray(feats[:, :2]),
        greedy=True)
    # Two frames single-shot on both sides: the same-padded conditioning of
    # a 2-frame call.
    pcm_t, st = tnet.net_synthesize_frames(
        tm, tp, tnet.net_vocoder_init(tm, 1, device="cpu"),
        _t(feats[:, :2]), greedy=True)
    np.testing.assert_allclose(pcm_t.numpy(), np.asarray(pcm_j), atol=1e-5)
    assert st.frame_ctr == 2
