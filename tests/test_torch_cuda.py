"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false (it is decided inside the fixture,
never at import, so every xdist worker collects the same tests).

Run them on a machine with an H100 (tests/conftest.py imports jax, which
that machine lacks, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dss_tpu_torch.device import resolve_device
from dss_tpu_torch.ops.frames import log_power_frames
from dss_tpu_torch.ops.log_power import log_power, log_power_plain
from dss_tpu_torch.ops.sampler import prepare_sampler_weights, \
    sampler_frames, sampler_frames_plain
from dss_tpu_torch.vocoder import net as tnet
from dss_tpu_torch.vocoder.lpc import bands_from_cepstrum, lpc_from_bands
from dss_tpu_torch.vocoder.lpcnet import _load_params

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")


@pytest.mark.parametrize("rows", [80, 120, 200, 360, 20000])
def test_log_power_kernel_matches_plain(dev, rows):
    """K1 at the packet shapes (n = 1, 2, 4, 8 packets) and an offline
    trial; atol 1e-5 (f32 sums of 50 squares in another order)."""
    x = torch.randn((rows, 64), generator=torch.Generator().manual_seed(rows))
    before = log_power.launches
    got = log_power_frames(x.to(dev), 1000)
    torch.cuda.synchronize()
    assert log_power.launches == before + 1
    W = got.shape[0]
    want = log_power_plain(x.to(dev), 10, 50, W)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _flagship_inputs(dev, frames, seed=0):
    params = _load_params(REPO / "weights" / "vocoder_speech.npz", dev)
    model = tnet.LPCNetModel.from_params(params)
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((1, frames, 20), generator=g) * 0.3
    feats[..., 0] -= 4.0
    feats = feats.to(dev)
    cond = model.condition(params, feats)
    lpc, _ = lpc_from_bands(bands_from_cepstrum(feats[..., :18]))
    corr = torch.clamp(feats[..., 19] + 0.5, 0.0, 1.0)
    temp = (1.0 + 1.5 * corr)
    state = tnet.net_vocoder_init(model, 1, device=dev)
    carry = (state.h_a, state.h_b, state.sig_mem, state.exc_idx)
    return (prepare_sampler_weights(params), carry,
            cond.transpose(0, 1).contiguous(),
            lpc.transpose(0, 1).contiguous(),
            temp.transpose(0, 1).contiguous())


def test_sampler_kernel_greedy_matches_plain(dev):
    """K2 at full width, greedy, two frames: identical excitations, PCM
    within 1e-5."""
    w, carry, cond, lpc, temp = _flagship_inputs(dev, 2)
    temp = -torch.ones_like(temp)
    kc, ks = sampler_frames(w, carry, cond, lpc, temp, None)
    pc, ps = sampler_frames_plain(w, carry, cond, lpc, temp, None)
    torch.cuda.synchronize()
    assert torch.equal(kc[3], pc[3])
    torch.testing.assert_close(ks, ps, atol=1e-5, rtol=0)


def test_sampler_kernel_stochastic_matches_plain_on_same_noise(dev):
    """K2 on one 50-frame block with shared noise: the outputs may part
    only after the first frame (last-bit differences feed back), and their
    RMS agree within 1 dB."""
    w, carry, cond, lpc, temp = _flagship_inputs(dev, 50, seed=1)
    noise = tnet.gumbel_noise(0, 0, 50, 1, dev)
    _, ks = sampler_frames(w, carry, cond, lpc, temp, noise)
    _, ps = sampler_frames_plain(w, carry, cond, lpc, temp, noise)
    diff = (ks - ps).abs()[0] > 1e-5
    first = int(torch.nonzero(diff)[0]) if bool(diff.any()) else ks.shape[1]
    assert first >= 160
    rms = lambda x: float(x.pow(2).mean().sqrt())  # noqa: E731
    assert abs(20 * np.log10(rms(ks) / rms(ps))) < 1.0


def test_chunked_equals_single_shot_on_the_card(dev):
    """Through the kernel, two 50-frame calls equal one 100-frame call."""
    params = _load_params(REPO / "weights" / "vocoder_speech.npz", dev)
    model = tnet.LPCNetModel.from_params(params)
    w = prepare_sampler_weights(params)
    feats = torch.randn((1, 100, 20),
                        generator=torch.Generator().manual_seed(2)) * 0.3
    feats = feats.to(dev)
    st = tnet.net_vocoder_init(model, 1, seed=3, device=dev)
    whole, _ = tnet.net_synthesize_frames(model, params, st, feats,
                                          sampler_weights=w)
    p1, s1 = tnet.net_synthesize_frames(model, params, st, feats[:, :50],
                                        sampler_weights=w)
    p2, _ = tnet.net_synthesize_frames(model, params, s1, feats[:, 50:],
                                       sampler_weights=w)
    assert torch.equal(torch.cat([p1, p2], dim=1), whole)
