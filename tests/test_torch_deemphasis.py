"""The neural vocoder's de-emphasis (ops/deemphasis.py, kernel D5) on the
CPU: the host loop against the plain version, splits of a stream and of a
batch, what it refuses, and that the net path runs it once a synthesis
block.  The kernel itself is held to the plain version on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from dss_tpu_torch.ops import deemphasis as deemph_mod
from dss_tpu_torch.ops.deemphasis import deemphasis, deemphasis_plain
from dss_tpu_torch.vocoder import net as tnet


def _signal(B, N, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, N), generator=g) * 0.2,
            torch.randn((B,), generator=g))


@pytest.mark.parametrize("B, N", [(1, 160), (3, 483), (16, 8000)])
def test_host_loop_is_the_plain_version(B, N):
    """On CPU tensors the host loop gives the plain version's y and carry
    bit for bit, from rows of a wider buffer into a column slice of
    another (the net path's layout)."""
    wide, y0 = _signal(B, N + 7, B * N)
    sig = wide[:, 3:3 + N]
    buf = torch.full((B, N + 320), np.nan)
    out = buf[:, 160:160 + N]
    last = deemphasis(sig, y0, out)
    want = deemphasis_plain(sig.numpy(), y0.numpy())
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(last.numpy(), want[:, -1])
    assert torch.isnan(buf[:, :160]).all() and torch.isnan(buf[:, -160:]).all()


@pytest.mark.parametrize("cuts", [(1,), (160, 161), (333, 4000, 7999)])
def test_any_split_of_a_stream_or_a_batch_equals_one_call(cuts):
    """A stream cut into calls at any samples, each call starting from the
    carry the one before returned, and a batch cut into shards, give one
    call's bits."""
    sig, y0 = _signal(5, 8000, 7)
    whole = torch.empty_like(sig)
    last = deemphasis(sig, y0, whole)
    parts, carry = torch.empty_like(sig), y0
    for a, b in zip((0,) + cuts, cuts + (8000,)):
        carry = deemphasis(sig[:, a:b], carry, parts[:, a:b])
    assert torch.equal(parts, whole) and torch.equal(carry, last)
    for lo, hi in ((0, 2), (2, 5), (4, 5)):
        shard = torch.empty((hi - lo, 8000))
        assert torch.equal(deemphasis(sig[lo:hi], y0[lo:hi], shard),
                           last[lo:hi])
        assert torch.equal(shard, whole[lo:hi])


def test_deemphasis_refuses_what_it_does_not_take():
    """Float64, a row stride in place of a column stride, a carry of
    another length or an output of another shape are refused; an empty
    block returns the carry it was given."""
    sig, y0 = _signal(2, 320, 0)
    out = torch.empty_like(sig)
    for args in ((sig.double(), y0, out), (sig.t().contiguous().t(), y0, out),
                 (sig, y0[:1], out), (sig, y0, out[:, :160])):
        with pytest.raises(ValueError):
            deemphasis(*args)
    assert torch.equal(deemphasis(sig[:, :0], y0, out[:, :0]), y0)


@pytest.mark.parametrize("T, blocks", [(50, 1), (120, 3)])
def test_net_path_deemphasizes_once_a_block(monkeypatch, T, blocks):
    """``net_synthesize_frames`` de-emphasizes each synthesis block once,
    the sampler's output from the carry of the block before, into the
    call's PCM clipped to [-1, 1]; the state keeps the last sample before
    clipping (the sampler stubbed out with a loud known signal)."""
    model = tnet.LPCNetModel(gru_a_units=16, gru_b_units=8, cond_dim=8,
                             embed_dim=8)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(4)
    feats = torch.randn((2, T, 20), generator=g) * 0.3
    sig = torch.randn((2, T * 160), generator=g) * 3.0
    calls, pos = [], [0]
    real = deemph_mod.deemphasis

    def spy(s, y0, out):
        calls.append(s.shape[1] // 160)
        return real(s, y0, out)

    def sampler_stub(w, carry, cond, lpc, temp, noise, frame_size):
        n = cond.shape[0] * frame_size
        pos[0] += n
        return carry, sig[:, pos[0] - n:pos[0]].clone()

    monkeypatch.setattr(deemph_mod, "deemphasis", spy)
    monkeypatch.setattr(tnet._sampler, "sampler_frames", sampler_stub)
    st = tnet.net_vocoder_init(model, 2, seed=2, device="cpu")
    st.deemph.fill_(0.5)
    pcm, st2 = tnet.net_synthesize_frames(model, params, st, feats,
                                          greedy=True)
    assert calls == [min(50, T - s) for s in range(0, T, 50)]
    assert len(calls) == blocks
    y = deemphasis_plain(sig.numpy(), st.deemph.numpy())
    assert np.abs(y).max() > 1.0
    assert np.array_equal(pcm.numpy(), np.clip(y, -1.0, 1.0))
    assert np.array_equal(st2.deemph.numpy(), y[:, -1])
