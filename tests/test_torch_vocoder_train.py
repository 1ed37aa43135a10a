"""The port's vocoder trainer against the JAX package's, on the CPU (the
teacher-forced LPC recursion runs D2's plain version here).

Both packages start from the same JAX-initialised parameters, carried over
by ``convert.vocoder_params``; every draw the JAX losses make internally
(the uniform jitter, the Gumbel noise) is reproduced here with
``jax.random`` from the same keys and injected into the port.  A tiny model
(GRU-A 32, GRU-B 8, cond 16, embed 16), B = 2, 2 frames (320 samples).

Tolerances:
* the recursion: indices exactly equal, pred and reconstruction atol 1e-6
  (the 16-tap sum in another order: XLA's against D2's pairwise tree).  An
  index could only differ where s - pred lies within a few ulps of a mu-law
  level's edge; ``_assert_same_indices`` allows that and nothing else;
* losses rtol 1e-5; gradients rtol 1e-4, atol 1e-6 (f32 GRU scans over
  320 steps, torch's cell and XLA's, each summing in its own order).  The
  losses compute the prediction's mu-law index from the recursion's pred,
  which the two packages sum in another order: a pred within an ulp of a
  level's edge would move that sample's gradient to the neighbouring row of
  ``emb_pred``.  On these seeds no index differs (a whole-program ``jit``
  of the JAX gradient, which sums in yet another order, does move one);
* STFT loss rtol 1e-5; its gradient atol 1e-4 of its largest element
  (two FFT libraries round apart, and log(|X| + 1e-5) is steep at the
  near-empty bins: measured 2.7e-5 of the largest at n = 1100);
* parameters after Adam updates: atol 1e-6 where every step's |g| exceeds
  ``FLOOR``; elsewhere 2 * lr a step (Adam's first updates are ~lr *
  sign(g), so a gradient at rounding noise may step the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.train.trainer_vocoder import VocoderTrainer as JTrainer
from dss_tpu.train.trainer_vocoder import _multi_res_stft_loss as j_stft
from dss_tpu.train.trainer_vocoder import prepare_utterance as j_prepare
from dss_tpu.vocoder import LPCNetModel as JModel
from dss_tpu_torch.convert import adam_state, vocoder_params
from dss_tpu_torch.ops.lpc_recursion import lpc_recursion_plain
from dss_tpu_torch.ops.sampler import tile_sparse_pattern
from dss_tpu_torch.train.trainer_vocoder import VocoderTrainer, \
    _multi_res_stft_loss, prepare_utterance
from dss_tpu_torch.vocoder.net import LPCNetModel

torch.set_num_threads(1)
TINY = dict(gru_a_units=32, gru_b_units=8, cond_dim=16, embed_dim=16)
B, T = 2, 2
S = T * 160
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
FLOOR = 1e-4


def _features(rng, B, T):
    """Plausible features: c0 around -4, small higher cepstra, pitch
    correlation in range (so the LPC filters are those of speech)."""
    f = rng.normal(size=(B, T, 20)).astype(np.float32) * 0.3
    f[..., 0] += -4.0
    f[..., 18] = rng.uniform(-0.5, 0.5, size=(B, T))
    f[..., 19] = rng.uniform(-0.5, 0.5, size=(B, T))
    return f


def _signal(rng, B, S):
    t = np.arange(S)
    sig = 0.3 * np.sin(2 * np.pi * t[None] / rng.uniform(40, 120, (B, 1)))
    return (sig + rng.normal(size=(B, S)) * 0.02).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Case:
    """One JAX trainer and its port at the same hyperparameters, from the
    same JAX-initialised parameters."""

    def __init__(self, bunch=1, seed=0, **kw):
        self.jm = JModel(**TINY, bunch=bunch)
        self.jt = JTrainer(self.jm, **kw)
        jp, self.jopt = self.jt.init(jax.random.PRNGKey(seed))
        self.jp_np = _np(jp)
        self.jp = {k: jnp.asarray(v) for k, v in self.jp_np.items()}
        self.tm = LPCNetModel(**TINY, bunch=bunch)
        self.tt = VocoderTrainer(self.tm, device="cpu", **kw)
        self.tp = self.tt.init(vocoder_params(self.jp_np))

    def port_value_and_grad(self, fn, *args):
        loss = fn(self.tp, *args)
        keys = self.tt.trainable
        gs = torch.autograd.grad(loss, [self.tp[k] for k in keys],
                                 allow_unused=True)
        return float(loss.detach()), {k: (g if g is not None
                                 else torch.zeros_like(self.tp[k])).numpy()
                             for k, g in zip(keys, gs)}

    def jax_value_and_grad(self, fn, *args, jit=False):
        """The JAX loss and gradient.  The JAX losses are jitted functions,
        differentiated from outside as the JAX tests do; ``jit`` compiles a
        function that is not (one program instead of op by op: faster)."""
        vg = jax.value_and_grad(lambda p: fn(p, *args))
        loss, g = (jax.jit(vg) if jit else vg)(self.jp)
        return float(loss), _np(g)


def _assert_grads(got, want):
    assert set(got) == set(want) - {"gru_a_mask"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return _features(rng, B, T), _signal(rng, B, S)


@pytest.fixture(scope="module")
def b1():
    return Case(bunch=1, noise_level=2, stft_weight=2.0)


def _jax_lpc_up(case, feats):
    _, lpc_up, _ = case.jt._prepare_cond(case.jp, jnp.asarray(feats))
    return np.asarray(lpc_up)


def _assert_same_indices(got, want, s, pred):
    """Indices equal, except that from the first difference of a stream on
    that stream may differ if that first difference sits on a mu-law level's
    edge: |q - round(q)| = 0.5 within 1e-4, q the level position of
    clip(s - pred)."""
    for b in range(got.shape[0]):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size == 0:
            continue
        i = diff[0]
        x = np.clip(s[b, i] - pred[b, i], -1.0, 1.0)
        y = np.sign(x) * np.log1p(255.0 * abs(x)) / np.log1p(255.0)
        q = (y + 1.0) * 0.5 * 255.0
        assert abs(abs(q - np.floor(q)) - 0.5) < 1e-4, (b, i, q)


def test_prepare_utterance_matches_jax():
    """Features within the encoder's parity tolerance (atol 1e-3, as the
    encoder's own test), the pre-emphasized signal exactly."""
    rng = np.random.default_rng(3)
    t = np.arange(160 * 6 + 37)
    audio = (3000 * np.sin(2 * np.pi * t / 91) + rng.normal(size=t.size)
             * 300).astype(np.int16)
    fj, sj = j_prepare(audio)
    ft, st = prepare_utterance(audio, device="cpu")
    assert ft.shape == fj.shape == (6, 20)
    np.testing.assert_allclose(ft, fj, atol=1e-3)
    np.testing.assert_array_equal(st, np.asarray(sj))


@pytest.mark.parametrize("n", [1100, 480, 200])
def test_stft_loss_matches_jax(n):
    """All three resolutions (n = 1100), one (480: only 256 fits) and the
    short-chunk fallback (200: 128); value and gradient in x."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, n)).astype(np.float32) * 0.2
    y = rng.normal(size=(2, n)).astype(np.float32) * 0.2
    lj, gj = jax.jit(jax.value_and_grad(lambda a: j_stft(a, jnp.asarray(y))))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    lt = _multi_res_stft_loss(xt, torch.tensor(y))
    (gt,) = torch.autograd.grad(lt, xt)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=1e-4 * np.abs(gj).max())


@pytest.mark.parametrize("bunch", [1, 4])
def test_model_init_matches_jax_layout(bunch):
    """Same keys, shapes and dtypes; ones and zeros where JAX puts them;
    Glorot draws inside their limits."""
    jp = _np(JModel(**TINY, bunch=bunch).init(jax.random.PRNGKey(0)))
    tp = LPCNetModel(**TINY, bunch=bunch).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert tp[k].dtype == torch.float32 and jp[k].dtype == np.float32, k
        v = tp[k].numpy()
        if np.all(jp[k] == 0) or np.all(jp[k] == 1):
            np.testing.assert_array_equal(v, jp[k], err_msg=k)
        else:
            lim = np.sqrt(6.0 / sum(jp[k].shape))
            assert np.abs(v).max() <= lim and v.std() > lim / 4, k
    again = LPCNetModel(**TINY, bunch=bunch).init(
        torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(tp[k], again[k]) for k in tp)


@pytest.mark.parametrize("mode", ["noise", "feedback"])
def test_recursion_matches_jax(b1, data, mode):
    """The recursion in both modes against JAX's scan (the mu-law rule of
    ``_assert_same_indices``), and D2's plain version equal to the port's
    ``_recursion`` bit for bit."""
    feats, sig = data
    rng = np.random.default_rng(11)
    if mode == "noise":
        inj = rng.integers(-2, 3, size=(B, S))
        jout = jax.jit(lambda s, l, n: b1.jt._recursion(s, l, noise=n))(
            sig, _jax_lpc_up(b1, feats), inj.astype(np.int32))
    else:
        inj = rng.integers(0, 256, size=(B, S))
        jout = jax.jit(lambda s, l, n: b1.jt._recursion(s, l, feedback=n))(
            sig, _jax_lpc_up(b1, feats), inj.astype(np.int32))
    jpred, jtgt, jfb, jrec = _np(jout)
    _, lpc, _ = b1.tt._prepare_cond(b1.tp, torch.tensor(feats))
    kw = {mode: torch.tensor(inj)}
    got = b1.tt._recursion(torch.tensor(sig), lpc.detach(), **kw)
    _assert_same_indices(got.exc_tgt.numpy(), jtgt, sig, jpred)
    _assert_same_indices(got.exc_fb.numpy(), jfb, sig, jpred)
    np.testing.assert_allclose(got.pred.numpy(), jpred, atol=1e-6)
    np.testing.assert_allclose(got.sig_rec.numpy(), jrec, atol=1e-6)
    plain = lpc_recursion_plain(torch.tensor(sig), lpc.detach(),
                                torch.tensor(inj), feedback=mode == "feedback",
                                drift_bound=b1.tt.drift_bound)
    for a, b in zip(plain, got):
        assert torch.equal(a, b)


def _teacher_inputs(case, feats, sig, rng):
    """The same drifted teacher inputs for both packages (from the JAX
    recursion with uniform jitter)."""
    cond_up, lpc_up, _ = case.jt._prepare_cond(case.jp, jnp.asarray(feats))
    noise = rng.integers(-2, 3, size=(B, S)).astype(np.int32)
    rec = _np(jax.jit(lambda s, l, n: case.jt._recursion(s, l, noise=n))(
        sig, lpc_up, noise))
    return rec


@pytest.mark.parametrize("bunch", [1, 4])
def test_forward_ce_matches_jax(data, bunch):
    """_forward_ce on the same teacher inputs: loss and every gradient (the
    conditioning network's through cond_up), and at bunch 1 the logits."""
    feats, sig = data
    case = Case(bunch=bunch)
    rec = _teacher_inputs(case, feats, sig, np.random.default_rng(5))
    jf = jnp.asarray(feats)

    def jfn(p, ret=False):
        cond_up, _, _ = case.jt._prepare_cond(p, jf)
        return case.jt._forward_ce(p, cond_up, *map(jnp.asarray, rec),
                                   return_logits=ret)

    def tfn(p, ret=False):
        cond, _, _ = case.tt._prepare_cond(p, torch.tensor(feats))
        pred, tgt, fb, srec = rec
        return case.tt._forward_ce(
            p, cond.repeat_interleave(160, 1), torch.tensor(pred),
            torch.tensor(tgt).long(), torch.tensor(fb).long(),
            torch.tensor(srec), return_logits=ret)

    lj, gj = case.jax_value_and_grad(jfn, jit=True)
    lt, gt = case.port_value_and_grad(tfn)
    np.testing.assert_allclose(lt, lj, **LOSS)
    _assert_grads(gt, gj)
    if bunch == 1:
        with torch.no_grad():
            logits = tfn(case.tp, True)
        want = jax.jit(lambda p: jfn(p, True))(case.jp)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _jax_draws(name, key, case):
    """The draws the JAX loss ``name`` makes from ``key``, as the port
    takes them."""
    K = case.jm.bunch
    _, k = jax.random.split(key)
    if name == "_loss":
        nl = case.jt.noise_level
        return torch.tensor(np.asarray(jax.random.randint(
            k, (B, S), -nl, nl + 1))).long()
    if name == "_loss_sampled":
        shape = (B, S, 256)
    elif K == 1:
        shape = (S, B, 256)
    else:
        shape = (S // K, B, K, 256)
    return torch.tensor(np.asarray(jax.random.gumbel(k, shape, jnp.float32)))


@pytest.mark.parametrize("name", ["_loss", "_loss_sampled", "_loss_freerun"])
def test_losses_match_jax(b1, data, name):
    """The three loss stages at bunch 1 with JAX's draws injected: loss and
    every gradient."""
    feats, sig = data
    key = jax.random.PRNGKey(3)
    lj, gj = b1.jax_value_and_grad(getattr(b1.jt, name), jnp.asarray(feats),
                                   jnp.asarray(sig), key)
    lt, gt = b1.port_value_and_grad(getattr(b1.tt, name),
                                    torch.tensor(feats), torch.tensor(sig),
                                    _jax_draws(name, key, b1))
    np.testing.assert_allclose(lt, lj, **LOSS)
    _assert_grads(gt, gj)


def test_freerun_loss_bunched_matches_jax(data):
    """The free-running loss at bunch 2 (``bunch_step`` rollout) with
    truncated backprop every 160 samples: loss and every gradient."""
    feats, sig = data
    case = Case(bunch=2, rollout_detach=160, stft_weight=2.0)
    key = jax.random.PRNGKey(4)
    lj, gj = case.jax_value_and_grad(case.jt._loss_freerun,
                                     jnp.asarray(feats), jnp.asarray(sig), key)
    lt, gt = case.port_value_and_grad(
        case.tt._loss_freerun, torch.tensor(feats), torch.tensor(sig),
        _jax_draws("_loss_freerun", key, case))
    np.testing.assert_allclose(lt, lj, **LOSS)
    _assert_grads(gt, gj)


def _assert_params_close(tp, jp, grads, lr, steps):
    """atol 1e-6 where every step's |g| > FLOOR; 2 * lr a step elsewhere
    (see the module docstring)."""
    for k in jp:
        got, want = tp[k].detach().numpy(), np.asarray(jp[k])
        if k == "gru_a_mask":
            np.testing.assert_array_equal(got, want)
            continue
        big = np.all([np.abs(g[k]) > FLOOR for g in grads], axis=0)
        np.testing.assert_allclose(got[big], want[big], atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got, want, atol=2 * lr * steps, err_msg=k)


def test_train_steps_match_jax(data):
    """One teacher-forced, one scheduled-sampling and one free-running
    update in turn, with lr_decay and grad_clip: each loss, the parameters
    after the three and the learning rate."""
    feats, sig = data
    lr = 3e-3
    case = Case(learning_rate=lr, lr_decay=0.05, grad_clip=1.0)
    jp, jopt = case.jp, case.jopt
    grads = []
    key = jax.random.PRNGKey(9)
    for name in ("train_step", "train_step_sampled", "train_step_freerun"):
        key, dk = jax.random.split(key)
        loss_name = {"train_step": "_loss",
                     "train_step_sampled": "_loss_sampled",
                     "train_step_freerun": "_loss_freerun"}[name]
        draws = _jax_draws(loss_name, dk, case)
        # The gradient at this step, for the comparison's |g| floor.
        grads.append(case.port_value_and_grad(
            getattr(case.tt, loss_name), torch.tensor(feats),
            torch.tensor(sig), draws)[1])
        jp, jopt, lj = getattr(case.jt, name)(jp, jopt, jnp.asarray(feats),
                                              jnp.asarray(sig), dk)
        lt = getattr(case.tt, name)(feats, sig, draws)
        np.testing.assert_allclose(float(lt), float(lj), **LOSS)
    _assert_params_close(case.tp, jp, grads, lr, 3)
    assert case.tt.optimizer.param_groups[0]["lr"] == pytest.approx(
        lr / (1 + 0.05 * 3))
    assert int(np.asarray(jopt[0].count)) == 3


def test_nonfinite_gradients_skip_update():
    """An inf or NaN gradient leaves parameters, Adam's moments and step
    count and the learning rate exactly as they were."""
    case = Case(learning_rate=1e-3, lr_decay=0.1, grad_clip=1.0)
    tt = case.tt
    ones = {k: torch.ones_like(tt.params[k]) for k in tt.trainable}
    assert tt._apply(ones)
    before = {k: v.detach().clone() for k, v in tt.params.items()}
    state = {i: {n: v.clone() for n, v in s.items()}
             for i, s in tt.optimizer.state_dict()["state"].items()}
    lr = tt.optimizer.param_groups[0]["lr"]
    for bad in (float("inf"), float("nan")):
        grads = {k: torch.ones_like(tt.params[k]) for k in tt.trainable}
        grads["gru_a_wx"][0, 0] = bad
        assert not tt._apply(grads)
        for k, v in tt.params.items():
            assert torch.equal(v, before[k]), k
        after = tt.optimizer.state_dict()["state"]
        for i, s in state.items():
            for n, v in s.items():
                assert torch.equal(after[i][n], v), (i, n)
        assert tt.optimizer.param_groups[0]["lr"] == lr
    assert all(s["step"] == 1 for s in state.values())
    assert lr == pytest.approx(1e-3 / 1.1)


def test_pruned_weights_stay_zero(data):
    """After sparsify, a teacher-forced update keeps the pruned weights at
    exactly zero (Adam's moments move them; the update re-zeroes)."""
    feats, sig = data
    case = Case(learning_rate=1e-2, noise_level=0)
    tt = case.tt
    tt.sparsify(tt.params, density=0.25, block=(8, 1))
    mask = tt.params["gru_a_mask"].numpy().copy()
    assert 0.2 <= mask.mean() <= 0.3
    for _ in range(2):
        tt.train_step(feats, sig)
    w = tt.params["gru_a_wh"].detach().numpy()
    assert np.all(w[mask == 0] == 0) and np.any(w[mask == 1] != 0)
    np.testing.assert_array_equal(tt.params["gru_a_mask"].numpy(), mask)


@pytest.mark.parametrize("size,density,block", [
    ("full", 0.2, None), ("tiny", 0.25, None), ("tiny", 0.5, (8, 1))])
def test_sparsify_mask_matches_jax(size, density, block):
    """The mask bit for bit: the full-width model at the sampler kernel's
    [16 x 128] tiles (which the kernel then reads: 43 of 216 kept), the
    tiny one at the 16 x 1 fallback and at an explicit block."""
    dims = {} if size == "full" else TINY
    model = LPCNetModel(**dims)
    init = model.init(torch.Generator().manual_seed(1), device="cpu")
    tp = {k: init[k] for k in ("gru_a_wh", "gru_a_mask")}
    jmask = np.asarray(JTrainer(JModel(**dims)).sparsify(
        {k: jnp.asarray(v.numpy()) for k, v in tp.items()}, density,
        block)["gru_a_mask"])
    VocoderTrainer(model, device="cpu").sparsify(tp, density, block)
    np.testing.assert_array_equal(tp["gru_a_mask"].numpy(), jmask)
    w = tp["gru_a_wh"].detach().numpy()
    assert np.all(w[jmask == 0] == 0)
    if size == "full":
        pattern, kept = tile_sparse_pattern(jmask)
        assert sum(len(p) for p in pattern) == 43 and kept == 43 / 216


def test_resume_from_converted_adam_state(data):
    """Two JAX updates, then the port resumes from the converted optax
    state (moments, count, schedule) and both take a third: equal
    parameters at the tolerance of the module docstring.  The converted
    moments are copies: the JAX state's arrays are left as they were."""
    feats, sig = data
    lr = 3e-3
    case = Case(learning_rate=lr, lr_decay=0.05, noise_level=0)
    jp, jopt = case.jp, case.jopt
    jf, js, key = jnp.asarray(feats), jnp.asarray(sig), jax.random.PRNGKey(0)
    for _ in range(2):
        jp, jopt, _ = case.jt.train_step(jp, jopt, jf, js, key)
    tt = VocoderTrainer(case.tm, learning_rate=lr, lr_decay=0.05,
                        noise_level=0, device="cpu")
    tp = tt.init(_np(jp))
    jopt_np = _np(jopt)
    mu_before = {k: v.copy() for k, v in jopt_np[0].mu.items()}
    state, count = adam_state(jopt_np, tp)
    assert count == 2
    tt.load_optimizer_state(state, count)
    assert tt.optimizer.param_groups[0]["lr"] == pytest.approx(
        lr / (1 + 0.05 * 2))
    loss = tt._loss(tp, torch.tensor(feats), torch.tensor(sig))
    g = torch.autograd.grad(loss, [tp[k] for k in tt.trainable])
    tt.train_step(feats, sig)
    jp, jopt, _ = case.jt.train_step(jp, jopt, jf, js, key)
    _assert_params_close(tp, jp, [{k: v.numpy() for k, v in zip(
        tt.trainable, g)}], lr, 1)
    for k, v in jopt_np[0].mu.items():
        np.testing.assert_array_equal(v, mu_before[k])
