"""The port's trainers against the JAX package's, on the CPU: the masked
losses, RMSprop against ``torch_rmsprop``, one nVAD TBPTT trial (B = 3
with an all-padding chunk that makes no update), one decoder step on a
padded batch, padded inference, a resume from a converted JAX optimizer
state, checkpoints read across packages, the dataset and its batches,
``run_lstm`` with host lengths, and the synthesis queue.

Both models run at dropout 0 here: JAX draws its masks with
``jax.random`` and ``nn.LSTM`` with torch's generator, so no stream is
shared.  Tolerances:
* losses and gradients rtol 1e-5, atol 1e-6 (f32 LSTMs in two frameworks);
* the update rule on identical gradients atol 1e-6;
* parameters after an update only where every step's |g| > 1e-4 at atol
  1e-6: RMSprop's first step moves every parameter by about 10 * lr *
  sign(g), however small g is, so an element whose gradient is rounding
  noise may step the other way in the other framework.  Elsewhere the
  bound is that: |difference| <= 2 * 10 * lr per step.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dss_tpu.models import BidirectionalSpeechSynthesisModel as JDec
from dss_tpu.models import UnidirectionalVoiceActivityDetector as JVad
from dss_tpu.models.torch_port import load_checkpoint as jload_checkpoint
from dss_tpu.train import StoreBestModel as JStoreBestModel
from dss_tpu.train import torch_rmsprop as jrmsprop
from dss_tpu.train.dataset import SequentialSpeechTrials as JTrials
from dss_tpu.train.dataset import padded_batches as jpadded_batches
from dss_tpu.train.trainer_decoder import DecoderTrainer as JDecoderTrainer
from dss_tpu.train.trainer_decoder import masked_mse as jmasked_mse
from dss_tpu.train.trainer_vad import VadTrainer as JVadTrainer
from dss_tpu.train.trainer_vad import masked_cross_entropy as jmasked_ce
from dss_tpu_torch.convert import lstm_state_dict, rmsprop_state
from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
from dss_tpu_torch.models.lstm import run_lstm
from dss_tpu_torch.models.torch_port import load_checkpoint
from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector
from dss_tpu_torch.ops.dsp_synthesis import dsp_synthesis
from dss_tpu_torch.train import AsynchronousSynthesisQueue, StoreBestModel, \
    load_train_state, save_train_state, torch_rmsprop
from dss_tpu_torch.train.dataset import SequentialSpeechTrials, datasets, \
    padded_batches, run_boundaries, squeeze_trial_ids
from dss_tpu_torch.train.trainer_decoder import DecoderTrainer, masked_mse
from dss_tpu_torch.train.trainer_vad import VadTrainer, \
    masked_cross_entropy
from dss_tpu_torch.utils.hdf import save_data_to_hdf
from dss_tpu_torch.vocoder.lpcnet import LPCNet

torch.set_num_threads(1)
LR = 1e-4
GRAD = dict(rtol=1e-5, atol=1e-6)
FLOOR = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def _assert_tree_close(got: dict, want_tree, head, **tol):
    want = lstm_state_dict(_np(want_tree), head)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def _assert_params_close(model, want_params, head, grads, steps):
    """Tight where every step's |g| > FLOOR, the sign-noise bound
    elsewhere (see the module docstring)."""
    want = lstm_state_dict(_np(want_params), head)
    for k, p in model.state_dict().items():
        d = np.abs(p.numpy() - want[k].numpy())
        big = np.all([np.abs(g[k].numpy()) > FLOOR for g in grads], axis=0)
        assert d[big].max(initial=0.0) <= 1e-6, k
        assert d.max() <= 2 * 10 * LR * steps + 1e-6, k


def _vad_pair(H=12, E=8, seed=0):
    jm = JVad(nb_layer=2, nb_hidden_units=H, nb_electrodes=E)
    jt = JVadTrainer(jm, learning_rate=LR, chunk=10)
    params, opt = jt.init(jax.random.PRNGKey(seed))
    tm = UnidirectionalVoiceActivityDetector(2, H, E)
    tm.load_state_dict(lstm_state_dict(_np(params), "classifier"))
    return jt, params, opt, VadTrainer(tm, learning_rate=LR, chunk=10,
                                       device="cpu")


def _dec_pair(H=10, E=8, F=5, seed=1):
    jm = JDec(nb_layer=2, nb_hidden_units=H, nb_electrodes=E, nb_outputs=F)
    jt = JDecoderTrainer(jm, learning_rate=LR, length_multiple=10)
    params, opt = jt.init(jax.random.PRNGKey(seed))
    tm = BidirectionalSpeechSynthesisModel(2, H, E, nb_outputs=F)
    tm.load_state_dict(lstm_state_dict(_np(params), "regressor"))
    return jt, params, opt, DecoderTrainer(tm, learning_rate=LR,
                                           length_multiple=10, device="cpu")


def _batch(rng, lengths, T, E, F=None):
    B = len(lengths)
    x = np.zeros((B, T, E), np.float32)
    y = np.zeros((B, T, F) if F else (B, T), np.float32)
    m = np.zeros((B, T), np.float32)
    for b, n in enumerate(lengths):
        x[b, :n] = rng.normal(size=(n, E))
        y[b, :n] = rng.normal(size=(n, F)) if F else rng.integers(0, 2, n)
        m[b, :n] = 1.0
    return x, y, m


def test_masked_losses_match_jax(rng):
    """Masked cross-entropy and MSE, with a partly and an entirely masked
    batch: rtol 1e-5, atol 1e-6."""
    logits = rng.normal(size=(3, 7, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (3, 7)).astype(np.float32)
    pred = rng.normal(size=(3, 7, 4)).astype(np.float32)
    target = rng.normal(size=(3, 7, 4)).astype(np.float32)
    for mask in (np.triu(np.ones((3, 7), np.float32)),
                 np.zeros((3, 7), np.float32)):
        got = masked_cross_entropy(*(torch.as_tensor(a) for a in
                                     (logits, labels, mask)))
        want = jmasked_ce(jnp.asarray(logits), jnp.asarray(labels),
                          jnp.asarray(mask))
        np.testing.assert_allclose(float(got), float(want), **GRAD)
        got = masked_mse(*(torch.as_tensor(a) for a in (pred, target, mask)))
        want = jmasked_mse(jnp.asarray(pred), jnp.asarray(target),
                           jnp.asarray(mask))
        np.testing.assert_allclose(float(got), float(want), **GRAD)


def test_rmsprop_matches_jax_torch_rmsprop(rng):
    """torch.optim.RMSprop (momentum 0, not centered) against the JAX
    package's torch_rmsprop on identical gradients over four steps, one of
    them with a zero gradient element: parameters and squared averages
    atol 1e-6."""
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0, 0.1)]
    grads[1][0, 0] = 0.0
    p = torch.nn.Parameter(torch.tensor(w0))
    opt = torch_rmsprop([p], 1e-2)
    assert opt.defaults["momentum"] == 0 and not opt.defaults["centered"]
    tx = jrmsprop(1e-2)
    params = jnp.asarray(w0)
    state = tx.init(params)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                                   atol=1e-6)
        np.testing.assert_allclose(opt.state[p]["square_avg"].numpy(),
                                   np.asarray(state["sq"]), atol=1e-6)


def test_vad_tbptt_trial_matches_jax(rng):
    """One TBPTT trial at B = 3 over three 10-frame chunks, the third all
    padding: mean chunk loss and the first chunk's gradients at the
    gradient tolerance, two optimizer steps (none for the padding chunk),
    squared averages and parameters after the trial (see the module
    docstring for the parameters' rule)."""
    jt, params, opt, tt = _vad_pair()
    x, y, m = _batch(rng, (20, 13, 7), 30, 8)
    state0 = jt.model.create_new_initial_state(3)

    def chunk_loss(p, k, state):
        sl = slice(10 * k, 10 * (k + 1))
        logits, new = jt.model.apply(p, jnp.asarray(x[:, sl]), state)
        return jmasked_ce(logits, jnp.asarray(y[:, sl]),
                          jnp.asarray(m[:, sl])), new
    g0 = jax.grad(lambda p: chunk_loss(p, 0, state0)[0])(params)

    steps, grads = [], []
    step = tt.optimizer.step

    def recording_step(*a, **kw):
        grads.append(_grads(tt.model))
        steps.append(len(steps))
        return step(*a, **kw)
    tt.optimizer.step = recording_step
    loss = tt.tbptt_trial(x, y, m)
    jp, jo, jloss = jt.tbptt_trial(params, opt, x, y, m,
                                   jax.random.PRNGKey(0))
    assert len(steps) == 2
    np.testing.assert_allclose(float(loss), float(jloss), **GRAD)
    _assert_tree_close(grads[0], g0, "classifier", **GRAD)
    sq = {k: tt.optimizer.state[p]["square_avg"]
          for k, p in tt.model.named_parameters()}
    _assert_tree_close(sq, jo["sq"], "classifier", rtol=1e-4, atol=1e-10)
    _assert_params_close(tt.model, jp, "classifier", grads, 2)

    # Evaluation: loss, correct frames, frames and speech probabilities.
    got = tt.evaluate(x, y, m)
    want = jt.evaluate(jp, x, y, m)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    assert float(got[2]) == float(want[2]) == 40.0
    assert abs(float(got[1]) - float(want[1])) <= 1.0
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-4)


def test_decoder_train_step_matches_jax(rng):
    """One full-BPTT step on a padded batch of three trials in no order of
    length (17, 30, 9 frames in 30): loss and gradients at the gradient
    tolerance, parameters after it (module docstring), and ``predict`` on
    the valid positions atol 1e-5."""
    jt, params, opt, tt = _dec_pair()
    x, y, m = _batch(rng, (17, 30, 9), 30, 8, 5)

    def loss_fn(p):
        pred, _ = jt.model.apply(p, jnp.asarray(x), None,
                                 mask=jnp.asarray(m))
        return jmasked_mse(pred, jnp.asarray(y), jnp.asarray(m))
    jloss, jg = jax.value_and_grad(loss_fn)(params)
    loss = tt.train_step(x, y, m)
    np.testing.assert_allclose(float(loss), float(jloss), **GRAD)
    g = _grads(tt.model)
    _assert_tree_close(g, jg, "regressor", **GRAD)
    jp, jo, jloss2 = jt.train_step(params, opt, x, y, m,
                                   jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(jloss2), float(jloss), rtol=1e-6)
    _assert_params_close(tt.model, jp, "regressor", [g], 1)

    got = tt.predict(x, m).numpy()
    want = np.asarray(jt.predict(jp, x, m))
    valid = m > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5)
    np.testing.assert_allclose(float(tt.evaluate(x, y, m)),
                               float(jt.evaluate(jp, x, y, m)), rtol=1e-4)


def test_decoder_padding_is_exact(rng):
    """Masked bidirectional inference and gradients on a padded batch
    equal the unpadded trials run alone (atol 1e-6 and the gradient
    tolerance): the packed LSTM never integrates the padding."""
    _, _, _, tt = _dec_pair()
    x, y, m = _batch(rng, (17, 6), 20, 8, 5)
    padded = tt.predict(x, m).numpy()
    for b, n in enumerate((17, 6)):
        alone = tt.predict(x[b:b + 1, :n]).numpy()
        np.testing.assert_allclose(padded[b, :n], alone[0], atol=1e-6)
    # One trial padded to 20 against the same trial unpadded.
    model = tt.model
    model.zero_grad()
    masked_mse(model(torch.as_tensor(x[:1]), lengths=[17])[0],
               torch.as_tensor(y[:1]), torch.as_tensor(m[:1])).backward()
    g_pad = _grads(model)
    model.zero_grad()
    masked_mse(model(torch.as_tensor(x[:1, :17]))[0],
               torch.as_tensor(y[:1, :17]),
               torch.ones((1, 17))).backward()
    for k, g in _grads(model).items():
        np.testing.assert_allclose(g_pad[k].numpy(), g.numpy(), err_msg=k,
                                   **GRAD)


@pytest.mark.parametrize("lengths", [(9, 5, 7), (9, 7, 5), (4,), (6, 6)])
def test_run_lstm_host_lengths_equal_the_mask(rng, lengths):
    """``lengths`` from the host and a mask give the same outputs on the
    valid positions and the same final state, in any order of length."""
    lstm = torch.nn.LSTM(3, 4, 2, batch_first=True, bidirectional=True)
    x, _, m = _batch(rng, lengths, 9, 3)
    with torch.no_grad():
        a, sa = run_lstm(lstm, torch.as_tensor(x), None, torch.as_tensor(m))
        b, sb = run_lstm(lstm, torch.as_tensor(x), None, lengths=lengths)
    valid = torch.as_tensor(m) > 0
    torch.testing.assert_close(a[valid], b[valid], rtol=0, atol=0)
    for s, t in zip(sa, sb):
        torch.testing.assert_close(s, t, rtol=0, atol=0)


def test_resume_from_converted_rmsprop_state(rng):
    """Two JAX decoder steps, then the parameters (``lstm_state_dict``) and
    the optimizer state (``rmsprop_state``) carried over: the next step in
    both packages gives the same loss and gradients (gradient tolerance),
    squared averages (rtol 1e-5) and parameters (module docstring)."""
    jt, params, opt, tt = _dec_pair(seed=3)
    batches = [_batch(rng, (20, 14), 20, 8, 5) for _ in range(3)]
    for x, y, m in batches[:2]:
        params, opt, _ = jt.train_step(params, opt, x, y, m,
                                       jax.random.PRNGKey(0))
    tt.model.load_state_dict(lstm_state_dict(_np(params), "regressor"))
    sd = tt.optimizer.state_dict()
    sd["state"] = rmsprop_state(_np(opt), tt.model, step=2)
    tt.optimizer.load_state_dict(sd)
    x, y, m = batches[2]
    loss = tt.train_step(x, y, m)
    jp, jo, jloss = jt.train_step(params, opt, x, y, m, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(loss), float(jloss), **GRAD)
    g = _grads(tt.model)
    sq = {k: tt.optimizer.state[p]["square_avg"]
          for k, p in tt.model.named_parameters()}
    _assert_tree_close(sq, jo["sq"], "regressor", rtol=1e-5, atol=1e-12)
    assert float(tt.optimizer.state[tt.model.regressor.bias]["step"]) == 3
    _assert_params_close(tt.model, jp, "regressor", [g], 1)
    with pytest.raises(ValueError):
        rmsprop_state(_np(opt), BidirectionalSpeechSynthesisModel(
            2, 11, 8, nb_outputs=5))


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_checkpoints_cross_load(tmp_path, suffix):
    """A best model written by either package loads into the other,
    equal; the store keeps the better score only."""
    jt, params, _, tt = _dec_pair()
    store = StoreBestModel(str(tmp_path / f"t{suffix}"), head_name="regressor")
    assert store.update(tt.model, validation_loss=2.0)
    assert not store.update(tt.model, validation_loss=3.0)
    with pytest.raises(ValueError):
        store.update(tt.model, validation_acc=1.0, validation_loss=1.0)
    want = tt.model.state_dict()
    jparams = jload_checkpoint(str(tmp_path / f"t{suffix}"), 2, True,
                               "regressor")
    for k, v in lstm_state_dict(_np(jparams), "regressor").items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)

    jstore = JStoreBestModel(str(tmp_path / f"j{suffix}"), head_name="regressor")
    assert jstore.update(params, validation_loss=1.0)
    got = load_checkpoint(str(tmp_path / f"j{suffix}"), 2, True, "regressor")
    for k, v in lstm_state_dict(_np(params), "regressor").items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    vad = StoreBestModel(str(tmp_path / f"v{suffix}"))
    assert vad.update(_vad_pair()[3].model, validation_acc=0.5)
    assert vad.current_best_validation_acc == 0.5
    assert jload_checkpoint(str(tmp_path / f"v{suffix}"), 2, False,
                            "classifier")["classifier"]["weight"].shape == (2, 12)


def test_train_state_resumes_the_run(rng, tmp_path):
    """save_train_state / load_train_state: a run stopped after one step
    and resumed in fresh objects continues exactly as the run that never
    stopped."""
    batches = [_batch(rng, (20, 11), 20, 8, 5) for _ in range(2)]
    _, _, _, a = _dec_pair()
    a.train_step(*batches[0])
    save_train_state(str(tmp_path / "s.pth"), a.model, a.optimizer,
                     extra={"epoch": 1})
    a.train_step(*batches[1])
    _, _, _, b = _dec_pair(seed=5)
    assert load_train_state(str(tmp_path / "s.pth"), b.model,
                            b.optimizer) == {"epoch": 1}
    b.train_step(*batches[1])
    for (k, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=k)


def test_dataset_and_batches_match_jax(rng, tmp_path):
    """SequentialSpeechTrials from .hdf files equals the JAX dataset (items,
    labels, repr), ``from_recordings`` on the same dicts equals it too, and
    padded_batches yields the JAX batches for the same seed."""
    recordings = {}
    for day, runs in (("2022_11_02", (1, 1, 2, -2, 1)), ("2022_11_03", (2, 1))):
        ids = np.concatenate([np.full(int(rng.integers(5, 40)), r, np.int16)
                              for r in runs])
        n = len(ids)
        (tmp_path / day).mkdir()
        f = str(tmp_path / day / "KeywordReading_Overt_R01.hdf")
        recordings[f] = dict(hga_activity=rng.normal(size=(n, 6)).astype(
            np.float32), lpc_coefficients=rng.normal(size=(n, 20)).astype(
            np.float32), vad_labels=rng.random(n) > 0.5, trial_ids=ids)
        save_data_to_hdf(f, recordings[f])
    files = sorted(recordings)
    for spec in ("lpc_coefficients", "vad_labels"):
        kw = dict(transform=lambda a: a[..., :4], target_specifier=spec)
        want = JTrials(files, **kw)
        for got in (SequentialSpeechTrials(files, **kw),
                    SequentialSpeechTrials.from_recordings(recordings, **kw),
                    datasets([files], None, **kw)[0],
                    datasets([files], recordings, **kw)[0]):
            assert len(got) == len(want) == 6
            assert got.trial_labels == want.trial_labels
            assert got.frame_counter == want.frame_counter
            assert repr(got) == repr(want)
            for i in range(len(got)):
                for a, b in zip(got[i], want[i]):
                    np.testing.assert_array_equal(a, b)
        for a, b in zip(padded_batches(want, 4, np.random.default_rng(1), 10),
                        jpadded_batches(want, 4, np.random.default_rng(1), 10)):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    seq = np.array([3, 3, -3, 1, 1, 1, 2])
    assert run_boundaries(seq) == [(0, 2), (2, 3), (3, 6), (6, 7)]
    assert squeeze_trial_ids(seq) == [3, 3, 1, 2]


def test_synthesis_queue_vocodes_and_skips_failed_jobs(rng, tmp_path, caplog):
    """Each job's wav holds frames x 160 int16 samples equal to the DSP
    vocoder's own output; a job that fails is logged and skipped and the
    queue goes on; on the CPU no kernel is launched."""
    feats = (rng.normal(size=(12, 20)) * 0.3).astype(np.float32)
    feats[:, 0] -= 2.0
    np.save(tmp_path / "a.npy", feats)
    np.save(tmp_path / "c.npy", feats[:5])
    before = dsp_synthesis.launches
    queue = AsynchronousSynthesisQueue(nb_processes=8, device="cpu")
    with caplog.at_level(logging.ERROR):
        for name in ("a.npy", "missing.npy", "c.npy"):
            queue.add_job(str(tmp_path / name))
        queue.wait()
    assert "missing.npy" in caplog.text
    from scipy.io import wavfile
    for name, n in (("a", 12), ("c", 5)):
        fs, pcm = wavfile.read(tmp_path / f"{name}.wav")
        assert fs == 16000 and pcm.dtype == np.int16 and len(pcm) == n * 160
        want = LPCNet(backend="dsp", device="cpu").synthesize_frames(feats[:n])
        np.testing.assert_array_equal(pcm, want)
    assert not (tmp_path / "missing.wav").exists()
    assert dsp_synthesis.launches == before
