"""Parity of the port's vocoder math and sampler with the JAX package, on
the CPU (the port's sampler runs its plain version here).

The sample loop is autoregressive: an argmax over 256 levels turns a
last-bit difference into a different excitation, which then feeds back.
Step functions are therefore compared teacher-forced (both sides fed the
same carry), and free-running comparisons are kept to at most two tiny
frames.  The JAX Pallas sampler runs in interpret mode, greedy, with f32
weights, as tests/test_pallas.py runs it.
"""

import os

os.environ["DSS_PALLAS_INTERPRET"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from dss_tpu.vocoder import lpc as jlpc  # noqa: E402
from dss_tpu.vocoder import mulaw as jmu  # noqa: E402
from dss_tpu.vocoder import net as jnet  # noqa: E402
from dss_tpu_torch.convert import vocoder_params  # noqa: E402
from dss_tpu_torch.ops.deemphasis import deemphasis  # noqa: E402
from dss_tpu_torch.ops.sampler import prepare_sampler_weights, \
    sampler_frames, tile_sparse_pattern  # noqa: E402
from dss_tpu_torch.vocoder import lpc as tlpc  # noqa: E402
from dss_tpu_torch.vocoder import mulaw as tmu  # noqa: E402
from dss_tpu_torch.vocoder import net as tnet  # noqa: E402

torch.set_num_threads(1)
TINY = dict(gru_a_units=16, gru_b_units=8, cond_dim=8, embed_dim=8)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _tiny(seed=0, inner_bias=False):
    jm = jnet.LPCNetModel(**TINY)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if inner_bias:
        rng = np.random.default_rng(seed)
        jp["fc_out1_b"] = rng.normal(size=256).astype(np.float32) * 0.3
        jp["fc_out2_b"] = rng.normal(size=256).astype(np.float32) * 0.3
    return jm, jp, tnet.LPCNetModel(**TINY), vocoder_params(jp)


def _features(rng, B, T):
    """Plausible 20-dim features: c0 around -6, small higher cepstra,
    pitch period and correlation in range."""
    f = rng.normal(size=(B, T, 20)).astype(np.float32) * 0.3
    f[..., 0] += -6.0
    f[..., 18] = rng.uniform(-0.5, 0.5, size=(B, T))
    f[..., 19] = rng.uniform(-0.5, 0.5, size=(B, T))
    return f


def test_mulaw_matches_jax(rng):
    """Encode is exact on 20k random samples; decode within 1e-6 on all
    256 levels (pow in two libraries)."""
    x = rng.uniform(-1.2, 1.2, size=20000).astype(np.float32)
    np.testing.assert_array_equal(tmu.mulaw_encode(_t(x)).numpy(),
                                  np.asarray(jmu.mulaw_encode(x)))
    idx = np.arange(256)
    np.testing.assert_allclose(tmu.mulaw_decode(_t(idx, torch.long)).numpy(),
                               np.asarray(jmu.mulaw_decode(idx)), atol=1e-6)



def test_mulaw_levels_are_the_nearest_float32_values():
    """Each of ``mulaw_decode``'s 256 levels is the float32 nearest the
    exact sign(y) (256^|y| - 1) / 255, and none lies within 1e-12
    (relative) of a rounding tie, so the sampler kernel's level, computed in
    double precision and rounded once, is the same float; a shaped and
    batched index gives the same levels."""
    y = np.arange(256, dtype=np.float64) / 255 * 2 - 1
    exact = np.sign(y) * np.expm1(np.abs(y) * np.log(256.0)) / 255
    got = tmu.mulaw_decode(torch.arange(256)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    up = np.nextafter(got, np.float32(np.inf)).astype(np.float64)
    down = np.nextafter(got, np.float32(-np.inf)).astype(np.float64)
    tie = np.minimum(np.abs(exact - (got + up) / 2),
                     np.abs(exact - (got + down) / 2))
    assert np.all(tie > 1e-12 * np.abs(exact))
    idx = torch.tensor([[0, 255], [127, 128]])
    np.testing.assert_array_equal(tmu.mulaw_decode(idx).numpy(),
                                  got[idx.numpy()])

def test_lpc_from_random_cepstra_matches_jax(rng):
    """bands_from_cepstrum and lpc_from_bands (lag-windowed Levinson) on
    random cepstra, batched.  rtol 1e-4 / atol 1e-4: f32 irfft and a
    16-step Levinson recursion in two libraries."""
    cep = rng.normal(size=(32, 18)).astype(np.float32) * 0.5
    cep[:, 0] -= 6.0
    bands_j = np.asarray(jlpc.bands_from_cepstrum(jnp.asarray(cep)))
    bands_t = tlpc.bands_from_cepstrum(_t(cep))
    np.testing.assert_allclose(bands_t.numpy(), bands_j, rtol=1e-5)
    lpc_j, err_j = jax.vmap(jlpc.lpc_from_bands)(jnp.asarray(bands_j))
    lpc_t, err_t = tlpc.lpc_from_bands(bands_t)
    np.testing.assert_allclose(lpc_t.numpy(), np.asarray(lpc_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-3)
    for name in ("FRAME_SIZE", "LPC_ORDER", "NB_BANDS", "NB_FEATURES",
                 "PREEMPH"):
        assert getattr(tlpc, name) == getattr(jlpc, name)


def test_deemphasis_blocked_equals_recurrence(rng):
    """The port's de-emphasis (the float32 recurrence, on the CPU the host
    loop) equals the recurrence y[t] = s[t] + 0.85 y[t-1] in float64, y and
    the returned carry y[-1]; atol 1e-5 (|y| <= 6.7)."""
    s = rng.uniform(-1, 1, size=(2, 3 * 160)).astype(np.float32)
    y0 = np.array([0.3, -2.0], np.float32)
    want = np.zeros(s.shape)
    prev = y0.astype(np.float64)
    for t in range(s.shape[1]):
        prev = s[:, t] + 0.85 * prev
        want[:, t] = prev
    got = torch.empty(s.shape)
    last = deemphasis(_t(s), _t(y0), got)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(last.numpy(), want[:, -1], atol=1e-5)


@pytest.mark.parametrize("inner_bias", [False, True])
def test_sample_step_teacher_forced_matches_jax(rng, inner_bias):
    """LPCNetModel.sample_step, teacher-forced with injected noise, over
    stochastic and greedy rows; atol 1e-5 on carries and logits."""
    jm, jp, tm, tp = _tiny(inner_bias=inner_bias)
    B = 3
    for step in range(4):
        carry = (rng.normal(size=(B, 16)).astype(np.float32) * 0.5,
                 rng.normal(size=(B, 8)).astype(np.float32) * 0.5,
                 rng.uniform(-0.3, 0.3, size=(B, 16)).astype(np.float32),
                 rng.integers(0, 256, size=B).astype(np.int32))
        cond = rng.normal(size=(B, 8)).astype(np.float32)
        lpc = rng.normal(size=(B, 16)).astype(np.float32) * 0.1
        gumbel = rng.gumbel(size=(B, 256)).astype(np.float32)
        temp = np.array([[1.3], [-1.0], [2.0]], np.float32)
        cj, (sj, ej, lj) = jm.sample_step(jp, tuple(map(jnp.asarray, carry)),
                                          cond, lpc, gumbel, temp)
        ct, (st, et, lt) = tm.sample_step(
            tp, (_t(carry[0]), _t(carry[1]), _t(carry[2]),
                 _t(carry[3], torch.long)),
            _t(cond), _t(lpc), _t(gumbel), _t(temp))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
        for a, b in zip(ct[:3], cj[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_sampler_plain_matches_jax_pallas_interpret(rng, monkeypatch):
    """The port's sampler (plain version on the CPU) vs the JAX Pallas
    kernel in interpret mode: greedy, stochastic=False, f32 weights, the
    tiny size of tests/test_pallas.py.  atol 1e-5; identical excitation."""
    import dss_tpu.ops.pallas.sampler as jsamp

    monkeypatch.setattr(jsamp, "_INTERPRET", True)
    jm, jp, _, tp = _tiny()
    B, T, F = 2, 3, 16
    cond = rng.normal(size=(B, T, 8)).astype(np.float32) * 0.5
    lpc = rng.normal(size=(B, T, 16)).astype(np.float32) * 0.05
    temp = -np.ones((B, T, 1), np.float32)
    carry0 = (np.zeros((B, 16), np.float32), np.zeros((B, 8), np.float32),
              np.zeros((B, 16), np.float32), np.full((B,), 128, np.int32))
    jc, jsig = jsamp.sampler_frames_pallas(
        jm, {k: jnp.asarray(v) for k, v in jp.items()},
        tuple(map(jnp.asarray, carry0)), jnp.asarray(cond), jnp.asarray(lpc),
        jnp.asarray(temp), seeds=jnp.arange(T, dtype=jnp.int32),
        frame_size=F, stochastic=False, weight_dtype=jnp.float32)
    w = prepare_sampler_weights(tp)
    tc, tsig = sampler_frames(
        w, (_t(carry0[0]), _t(carry0[1]), _t(carry0[2]),
            _t(carry0[3], torch.long)),
        _t(cond).transpose(0, 1).contiguous(),
        _t(lpc).transpose(0, 1).contiguous(),
        _t(temp[..., 0]).transpose(0, 1).contiguous(), None, F)
    np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), atol=1e-5)
    for a, b in zip(tc[:3], jc[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_array_equal(tc[3].numpy(), np.asarray(jc[3]))


def _jax_state(jm, seed, B):
    return jnet.net_vocoder_init(jm, batch=B, seed=seed)


@pytest.mark.parametrize("greedy", [True, False])
def test_net_synthesize_frames_matches_jax_scan(rng, greedy):
    """net_synthesize_frames over two tiny frames vs the JAX scan path:
    greedy, and stochastic with the JAX Gumbel noise (from the same
    fold_in(rng, frame) keys) injected.  atol 1e-5 on PCM and state."""
    jm, jp, tm, tp = _tiny(seed=2)
    B, T, seed = 2, 2, 11
    feats = _features(rng, B, T)
    jst = _jax_state(jm, seed, B)
    pcm_j, jst2 = jnet.net_synthesize_frames(
        jm, {k: jnp.asarray(v) for k, v in jp.items()}, jst,
        jnp.asarray(feats), greedy=greedy, quiet_sharpen=True)
    keys = jax.vmap(lambda t: jax.random.fold_in(jst.rng, t))(
        jnp.arange(T, dtype=jnp.int32))
    gumbel = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (160, B, 256), jnp.float32))(keys))
    tst = tnet.net_vocoder_init(tm, batch=B, seed=seed, device="cpu")
    pcm_t, tst2 = tnet.net_synthesize_frames(
        tm, tp, tst, _t(feats), greedy=greedy, quiet_sharpen=True,
        gumbel=None if greedy else _t(gumbel))
    np.testing.assert_allclose(pcm_t.numpy(), np.asarray(pcm_j), atol=1e-5)
    np.testing.assert_allclose(tst2.h_a.numpy(), np.asarray(jst2.h_a),
                               atol=1e-5)
    np.testing.assert_array_equal(tst2.exc_idx.numpy(),
                                  np.asarray(jst2.exc_idx))
    np.testing.assert_allclose(tst2.deemph.numpy(), np.asarray(jst2.deemph),
                               atol=1e-5)
    assert tst2.frame_ctr == T


def test_gumbel_noise_is_keyed_by_absolute_frame():
    """Noise of a frame depends on (seed, absolute frame) only; it is
    capped at NOISE_CAP and looks like a Gumbel sample."""
    a = tnet.gumbel_noise(5, 0, 4, 1, "cpu")
    b = tnet.gumbel_noise(5, 2, 2, 1, "cpu")
    c = tnet.gumbel_noise(6, 0, 4, 1, "cpu")
    assert torch.equal(a[2:], b)
    assert not torch.equal(a, c)
    assert float(a.max()) <= tnet.NOISE_CAP
    assert abs(float(a.mean()) - 0.5772) < 0.02   # Euler-Mascheroni
    assert abs(float(a.std()) - 1.2825) < 0.03    # pi / sqrt(6)


def test_chunked_equals_single_shot(rng):
    """Two 50-frame calls give exactly the audio and state of one 100-frame
    call (the COND_BLOCK discipline and absolute-frame noise keys)."""
    _, _, tm, tp = _tiny(seed=3)
    feats = _t(_features(rng, 1, 100))
    w = prepare_sampler_weights(tp)
    st = tnet.net_vocoder_init(tm, batch=1, seed=4, device="cpu")
    whole, s_whole = tnet.net_synthesize_frames(
        tm, tp, st, feats, quiet_sharpen=True, sampler_weights=w)
    p1, s1 = tnet.net_synthesize_frames(tm, tp, st, feats[:, :50],
                                        quiet_sharpen=True, sampler_weights=w)
    p2, s2 = tnet.net_synthesize_frames(tm, tp, s1, feats[:, 50:],
                                        quiet_sharpen=True, sampler_weights=w)
    assert torch.equal(torch.cat([p1, p2], dim=1), whole)
    assert torch.equal(s2.h_a, s_whole.h_a)
    assert s2.frame_ctr == s_whole.frame_ctr == 100


def test_tile_sparse_pattern_matches_jax():
    """The copied tile keep-pattern of the shipped flagship's GRU-A mask,
    and its kept fraction (19.9% of [16 x 128] tiles)."""
    from dss_tpu.ops.pallas.sampler import tile_sparse_pattern as j_tsp

    with np.load("weights/vocoder_speech.npz") as f:
        mask = f["gru_a_mask"]
    got, kept = tile_sparse_pattern(mask)
    want, kept_j = j_tsp(mask)
    assert got == want and kept == kept_j
    assert abs(kept - 0.199) < 0.001
