"""Parity of the port's LSTM models and checkpoint loading with the JAX
package, on the CPU.  Parameters come from the JAX initializers and cross
over through dss_tpu_torch.convert as numpy."""

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.models import BidirectionalSpeechSynthesisModel as JDec
from dss_tpu.models import UnidirectionalVoiceActivityDetector as JVad
from dss_tpu.models.torch_port import to_torch_state_dict
from dss_tpu_torch.convert import lstm_state_dict
from dss_tpu_torch.models import decoder as tdecoder
from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel, \
    hold_last_frame
from dss_tpu_torch.models.lstm import run_lstm, seeded_init
from dss_tpu_torch.ops import bilstm
from dss_tpu_torch.models.torch_port import load_checkpoint
from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vad_pair(seed=0):
    jm = JVad(nb_layer=2, nb_hidden_units=12, nb_electrodes=8)
    jp = _np_tree(jm.init(jax.random.PRNGKey(seed)))
    tm = UnidirectionalVoiceActivityDetector(2, 12, 8)
    tm.load_state_dict(lstm_state_dict(jp, "classifier"))
    return jm, jp, tm.eval()


def _dec_pair(seed=1):
    jm = JDec(nb_layer=2, nb_hidden_units=10, nb_electrodes=8, nb_outputs=20)
    jp = _np_tree(jm.init(jax.random.PRNGKey(seed)))
    tm = BidirectionalSpeechSynthesisModel(2, 10, 8, nb_outputs=20)
    tm.load_state_dict(lstm_state_dict(jp, "regressor"))
    return jm, jp, tm.eval()


@torch.no_grad()
def test_vad_streaming_carry_matches_jax(rng):
    """Packet-by-packet VAD with the carried (h, c) [L*D, B, H] equals the
    JAX model, and equals one pass over the whole stream.  atol 1e-5:
    f32 LSTM arithmetic in two frameworks."""
    jm, jp, tm = _vad_pair()
    x = rng.normal(size=(1, 24, 8)).astype(np.float32)
    js = jm.create_new_initial_state(1)
    ts = tm.create_new_initial_state(1)
    assert tuple(ts[0].shape) == (2, 1, 12)
    outs_j, outs_t = [], []
    for k in range(0, 24, 4):
        lj, js = jm.apply(jp, jnp.asarray(x[:, k:k + 4]), js)
        lt, ts = tm(torch.as_tensor(x[:, k:k + 4]), ts)
        outs_j.append(np.asarray(lj))
        outs_t.append(lt.numpy())
    np.testing.assert_allclose(np.concatenate(outs_t, 1),
                               np.concatenate(outs_j, 1), atol=1e-5)
    np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), atol=1e-5)
    np.testing.assert_allclose(ts[1].numpy(), np.asarray(js[1]), atol=1e-5)
    whole, _ = tm(torch.as_tensor(x))
    np.testing.assert_allclose(whole.numpy(), np.concatenate(outs_t, 1),
                               atol=1e-5)


@torch.no_grad()
def test_decoder_masked_padding_matches_jax_and_unpadded(rng):
    """Right-padded masked batches equal unpadded runs in both directions
    (valid positions and final state), and equal the JAX masked scan at
    valid positions.  atol 1e-5 (f32 LSTM arithmetic)."""
    jm, jp, tm = _dec_pair()
    lengths = [13, 20]
    x = np.zeros((2, 20, 8), np.float32)
    mask = np.zeros((2, 20), np.float32)
    for b, n in enumerate(lengths):
        x[b, :n] = rng.normal(size=(n, 8))
        x[b, n:] = 5.0  # garbage in the padding must not leak
        mask[b, :n] = 1.0
    y_t, (h_t, c_t) = tm(torch.as_tensor(x), mask=torch.as_tensor(mask))
    y_j, (h_j, _) = jm.apply(jp, jnp.asarray(x), None,
                             mask=jnp.asarray(mask))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(y_t[b, :n].numpy(),
                                   np.asarray(y_j)[b, :n], atol=1e-5)
        alone, (h_a, _) = tm(torch.as_tensor(x[b:b + 1, :n]))
        np.testing.assert_allclose(y_t[b, :n].numpy(), alone[0].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(h_t[:, b].numpy(), h_a[:, 0].numpy(),
                                   atol=1e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5)


@pytest.mark.parametrize("suffix", [".npz", ".pth"])
def test_load_checkpoint_formats(tmp_path, suffix):
    """A torch-layout state_dict saved as .npz (the JAX trainers' format)
    or .pth loads into the port's decoder and reproduces the JAX model."""
    jm, jp, _ = _dec_pair(seed=4)
    sd = to_torch_state_dict(jp, "regressor")
    path = tmp_path / f"dec{suffix}"
    if suffix == ".npz":
        np.savez(path, **sd)
    else:
        torch.save({k: torch.as_tensor(v) for k, v in sd.items()}, path)
    tm = BidirectionalSpeechSynthesisModel(2, 10, 8, nb_outputs=20).eval()
    tm.load_state_dict(load_checkpoint(str(path), 2, True, "regressor"))
    x = np.random.default_rng(5).normal(size=(1, 7, 8)).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.as_tensor(x))[0].numpy()
    want = np.asarray(jm.apply(jp, jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(KeyError):
        load_checkpoint(str(path), 2, True, "classifier")


def test_seeded_init_is_reproducible():
    """Random models are made from an explicit generator: same seed, same
    weights; another seed, other weights."""
    a = seeded_init(BidirectionalSpeechSynthesisModel(2, 10, 8), 3)
    b = seeded_init(BidirectionalSpeechSynthesisModel(2, 10, 8), 3)
    c = seeded_init(BidirectionalSpeechSynthesisModel(2, 10, 8), 4)
    for (k, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(p, q), k
        assert not torch.equal(p, r), k
        assert p.abs().max() <= 1.0 / np.sqrt(10) + 1e-6


@torch.no_grad()
@pytest.mark.parametrize("lengths", [[1], [49], [50], [137], [300],
                                     [40, 13, 29]])
def test_bilstm_decode_plain_matches_the_packed_lstm(lengths):
    """D3's plain version against nn.LSTM's packed run (run_lstm with the
    lengths) from a random state, at H = 14 (a ragged last lane group):
    every valid frame, the final (h, c) and the repeat-padded tail (3
    frames past the input); on the ragged batch also against the JAX
    decoder's masked scan with the same parameters (valid frames and final
    (h, c)).  atol 1e-5 (f32 sums in another order)."""
    B, Tx = len(lengths), max(lengths)
    jm = JDec(nb_layer=2, nb_hidden_units=14, nb_electrodes=10, nb_outputs=5)
    jp = _np_tree(jm.init(jax.random.PRNGKey(7)))
    m = BidirectionalSpeechSynthesisModel(2, 14, 10, nb_outputs=5)
    m.load_state_dict(lstm_state_dict(jp, "regressor"))
    m.eval()
    g = torch.Generator().manual_seed(Tx + B)
    x = torch.randn((B, Tx, 10), generator=g)
    for b, n in enumerate(lengths):
        x[b, n:] = 5.0  # garbage in the padding must not leak
    state = tuple(0.3 * torch.randn((4, B, 14), generator=g) for _ in "hc")
    y, (h, c) = run_lstm(m.lstm, x, state, lengths=lengths)
    want = hold_last_frame(m.regressor(y), lengths, Tx + 3)
    got, (gh, gc) = bilstm.bilstm_decode_plain(
        x, lengths, bilstm.decoder_weights(m.lstm, m.regressor), state,
        Tx + 3)
    assert got.shape == (B, Tx + 3, 5)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(gh, h, atol=1e-5, rtol=0)
    torch.testing.assert_close(gc, c, atol=1e-5, rtol=0)
    if B == 1:
        return
    mask = (torch.arange(Tx)[None] < torch.as_tensor(lengths)[:, None])
    y_j, (h_j, c_j) = jm.apply(jp, jnp.asarray(x.numpy()),
                               tuple(jnp.asarray(t.numpy()) for t in state),
                               mask=jnp.asarray(mask.float().numpy()))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n].numpy(),
                                   np.asarray(y_j)[b, :n], atol=1e-5)
    np.testing.assert_allclose(gh.numpy(), np.asarray(h_j), atol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(c_j), atol=1e-5)


def test_decoder_routes_to_the_kernel_only_where_it_may(monkeypatch):
    """forward runs run_lstm with gradients on and on CPU tensors; the
    kernel is taken only on a CUDA device with gradients off, dropout
    inactive and a width the plan takes (its answer simulated here)."""
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return run_lstm(*a, **k)

    monkeypatch.setattr(tdecoder, "run_lstm", spy)
    monkeypatch.setattr(bilstm, "kernel_plan", lambda E, H, L, F: dict(
        max_hidden=12, supported=H <= 12))
    narrow = BidirectionalSpeechSynthesisModel(2, 12, 8, dropout=0.5)
    wide = BidirectionalSpeechSynthesisModel(2, 13, 8)
    x = torch.randn((1, 6, 8))
    narrow(x)
    with torch.no_grad():
        narrow.eval()(x)
    assert len(calls) == 2
    cuda = torch.device("cuda")
    assert not narrow.takes_kernel("cpu")
    assert not narrow.train().takes_kernel(cuda)  # grad on
    with torch.no_grad():
        assert not narrow.takes_kernel(cuda)      # dropout active
        assert narrow.eval().takes_kernel(cuda)
        assert not wide.eval().takes_kernel(cuda)  # above the plan's H
