"""The neural vocoder's LPC route (ops/cepstrum_lpc.py, kernel D4) on the
CPU: the wrapper's plain version, what it refuses, and that the net path
takes it once a synthesis block.  The kernel itself is held to the plain
version on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from dss_tpu_torch.ops import cepstrum_lpc
from dss_tpu_torch.ops.cepstrum_lpc import lpc_frames, lpc_frames_plain
from dss_tpu_torch.vocoder import lpc as tlpc
from dss_tpu_torch.vocoder import net as tnet


def _features(B, T, seed, scale=0.3, c0=-4.0):
    g = torch.Generator().manual_seed(seed)
    f = torch.randn((B, T, 20), generator=g) * scale
    f[..., 0] += c0
    return f


@pytest.mark.parametrize("B, L", [(1, 1), (1, 50), (3, 37), (16, 50)])
def test_lpc_frames_on_the_cpu_is_the_framewise_route(B, L):
    """On a CPU tensor the wrapper returns ``lpc_from_cepstrum_framewise``
    on the first 18 columns in the sampler's layout [L, B, 16], for the
    strided view the vocoder passes (a slice of features after their
    context frames) as for a contiguous copy, bit for bit; and that is
    within 1e-5 of the library route ``lpc_from_bands(bands_from_cepstrum
    (.))`` (the same sums in another order; taps up to ~0.5 here)."""
    feats = _features(B, L + 2, 10 * B + L)
    view = feats[:, 2:]
    want, _ = tlpc.lpc_from_cepstrum_framewise(view[..., :18])
    got = lpc_frames(view)
    assert got.shape == (L, B, 16) and got.is_contiguous()
    assert torch.equal(got, want.transpose(0, 1))
    assert torch.equal(lpc_frames(view.contiguous()), got)
    assert torch.equal(lpc_frames_plain(view[..., :18]), got)
    lib, _ = tlpc.lpc_from_bands(tlpc.bands_from_cepstrum(view[..., :18]))
    np.testing.assert_allclose(got.numpy(), lib.transpose(0, 1).numpy(),
                               atol=1e-5, rtol=0)


def test_lpc_frames_refuses_what_it_does_not_take():
    """Float64, fewer than 18 columns and a missing batch axis are
    refused; an empty block gives empty taps."""
    f = _features(2, 3, 0)
    for bad in (f.double(), f[..., :17], f[0]):
        with pytest.raises(ValueError):
            lpc_frames(bad)
    assert lpc_frames(f[:, :0]).shape == (0, 2, 16)


@pytest.mark.parametrize("T, blocks", [(50, 1), (120, 3), (37, 1)])
def test_net_path_takes_the_route_once_a_block(monkeypatch, T, blocks):
    """``net_synthesize_frames`` computes its LPC through ``lpc_frames``,
    one call a synthesis block (50 frames, a shorter last one), on the
    block's features: what the sampler gets is that call's result (the
    sampler stubbed out: only the route is checked here)."""
    model = tnet.LPCNetModel(gru_a_units=16, gru_b_units=8, cond_dim=8,
                             embed_dim=8)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    feats = _features(2, T, 3)
    calls, seen = [], []
    real = cepstrum_lpc.lpc_frames

    def spy(c):
        calls.append(c.shape)
        out = real(c)
        seen.append(out)
        return out

    def sampler_spy(w, carry, cond, lpc, temp, noise, frame_size):
        assert any(lpc is s for s in seen)
        assert lpc.shape == (cond.shape[0], 2, 16)
        return carry, torch.zeros((2, cond.shape[0] * frame_size))

    monkeypatch.setattr(cepstrum_lpc, "lpc_frames", spy)
    monkeypatch.setattr(tnet._sampler, "sampler_frames", sampler_spy)
    st = tnet.net_vocoder_init(model, 2, seed=2, device="cpu")
    pcm, _ = tnet.net_synthesize_frames(model, params, st, feats,
                                        greedy=True)
    assert len(calls) == blocks
    assert [c[1] for c in calls] == [min(50, T - s) for s in range(0, T, 50)]
    assert pcm.shape == (2, T * 160)
