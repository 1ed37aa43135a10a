"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false (it is decided inside the fixture,
never at import, so every xdist worker collects the same tests).

Run them on a machine with an H100 (tests/conftest.py imports jax, which
that machine lacks, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from dss_tpu_torch.device import resolve_device
from dss_tpu_torch.ops.dsp_synthesis import DspCarry, dsp_synthesis, \
    dsp_synthesis_blocked_plain, dsp_synthesis_host, dsp_vocode
from dss_tpu_torch.ops import hga as thga
from dss_tpu_torch.ops.cepstrum_lpc import lpc_frames, lpc_frames_plain
from dss_tpu_torch.ops.deemphasis import deemphasis, deemphasis_plain
from dss_tpu_torch.ops.filter_log_power import filter_log_power, \
    filter_log_power_plain
from dss_tpu_torch.ops.frames import log_power_frames
from dss_tpu_torch.ops.hga import HighGammaExtractor
from dss_tpu_torch.ops.log_power import log_power, log_power_plain
from dss_tpu_torch.ops.lpc_recursion import lpc_recursion, \
    lpc_recursion_plain
from dss_tpu_torch.ops.sampler import kernel_plan, \
    prepare_bunched_sampler_weights, prepare_sampler_weights, sampler_frames, sampler_frames_bunched, \
    sampler_frames_bunched_plain, sampler_frames_plain
from dss_tpu_torch import vocoder as tvoc
from dss_tpu_torch.vocoder import dsp as tdsp
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


# (T, R) of chip_smoke.py's front-end phase: a packet with the steady carry,
# 2 / 4 / 8 coalesced packets, a packet shorter than the overlap, a short
# first packet zero-padded to one frame, and an offline trial (R = 0).
FRONT_END_CASES = [(40, 40), (80, 40), (160, 40), (320, 40), (10, 40),
                   (30, 20), (20000, 0)]


def _front_end_inputs(dev, T, R, C=64, sections=16):
    ex = HighGammaExtractor(fs=1000, nb_electrodes=C, device=dev)
    g = torch.Generator().manual_seed(T + R)
    x = torch.randn((T, C), generator=g).to(dev)
    carry = torch.randn((R, C), generator=g).to(dev)
    zi = ex.zi + 0.1 * torch.randn(ex.zi.shape, generator=g).to(dev)
    return ex.sos[:sections].contiguous(), x, zi[:sections].contiguous(), \
        carry


@pytest.mark.parametrize("T, R", FRONT_END_CASES)
def test_front_end_kernel_matches_plain(dev, T, R):
    """The fused front-end kernel at the deployed cascade and width: zf and
    the carried rows bit for bit (both round once per operation in the same
    order), features within 1e-5 (window sums in another order); one launch
    counted."""
    sos, x, zi, carry = _front_end_inputs(dev, T, R)
    before = filter_log_power.launches
    feats, zf, carry_out = filter_log_power(sos, x, zi, carry, 10, 50)
    torch.cuda.synchronize()
    assert filter_log_power.launches == before + 1
    want = filter_log_power_plain(sos, x, zi, carry, 10, 50)
    assert feats.shape == want[0].shape
    assert torch.equal(zf, want[1])
    assert torch.equal(carry_out, want[2])
    torch.testing.assert_close(feats, want[0], atol=1e-5, rtol=0)


def test_front_end_kernel_generic_section_count(dev):
    """The kernel's generic path (section count other than 16: the
    band-pass alone, 8 sections) at a width that 32 does not divide."""
    sos, x, zi, carry = _front_end_inputs(dev, 120, 40, C=70, sections=8)
    feats, zf, carry_out = filter_log_power(sos, x, zi, carry, 10, 50)
    want = filter_log_power_plain(sos, x, zi, carry, 10, 50)
    assert torch.equal(zf, want[1])
    assert torch.equal(carry_out, want[2])
    torch.testing.assert_close(feats, want[0], atol=1e-5, rtol=0)


def test_front_end_session_state_carried_by_the_kernel(dev, monkeypatch):
    """A 4 s, 129 -> 64-channel session packet by packet through
    HighGammaExtractor.packet_step with the deployed transforms, the state
    carried by the kernel alone, against the same through the plain
    version on the card: every frame within 1e-5, final state identical."""
    from dss_tpu_torch.apps.decode_online import feature_transforms
    raw = torch.randn((4000, 129), generator=torch.Generator().manual_seed(9))
    runs = []
    for fn in (filter_log_power, filter_log_power_plain):
        monkeypatch.setattr(thga, "filter_log_power", fn)
        pre, post, nb = feature_transforms(None)
        ex = HighGammaExtractor(fs=1000, nb_electrodes=nb, pre_transforms=pre,
                                post_transforms=post, device=dev)
        st, frames = ex.init_state(), []
        for k in range(0, 4000, 40):
            f, st = ex.packet_step(st, raw[k:k + 40].to(dev))
            frames.append(f)
        runs.append((torch.cat(frames), st))
    (fk, sk), (fp, sp) = runs
    torch.testing.assert_close(fk, fp, atol=1e-5, rtol=0)
    assert torch.equal(sk.zi, sp.zi)
    assert torch.equal(sk.remainder, sp.remainder)


def test_front_end_kernel_refuses_what_it_does_not_take(dev):
    """On CUDA tensors the wrapper launches or raises: float64 input, state
    left on the CPU and a mis-shaped carry are refused."""
    sos, x, zi, carry = _front_end_inputs(dev, 40, 40)
    with pytest.raises(TypeError):
        filter_log_power(sos, x.double(), zi, carry, 10, 50)
    with pytest.raises(ValueError):
        filter_log_power(sos, x, zi.cpu(), carry, 10, 50)
    with pytest.raises(ValueError):
        filter_log_power(sos, x, zi, carry[:, :32], 10, 50)


def _flagship_inputs(dev, frames, seed=0, name="vocoder_speech.npz",
                     batch=1):
    params = _load_params(REPO / "weights" / name, dev)
    model = tnet.LPCNetModel.from_params(params)
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((batch, frames, 20), generator=g) * 0.3
    feats[..., 0] -= 4.0
    feats = feats.to(dev)
    cond = model.condition(params, feats)
    lpc, _ = lpc_from_bands(bands_from_cepstrum(feats[..., :18]))
    corr = torch.clamp(feats[..., 19] + 0.5, 0.0, 1.0)
    temp = (1.0 + 1.5 * corr)
    state = tnet.net_vocoder_init(model, batch, device=dev)
    carry = (state.h_a, state.h_b, state.sig_mem, state.exc_idx)
    return (tnet.sampler_weights_for(model, params), carry,
            cond.transpose(0, 1).contiguous(),
            lpc.transpose(0, 1).contiguous(),
            temp.transpose(0, 1).contiguous())


@pytest.mark.parametrize("batch", [1, 8])
def test_sampler_kernel_greedy_matches_plain(dev, batch):
    """The kernel at S = 1 and full width, greedy, two frames, one stream
    and eight: identical excitations, PCM and state within 1e-5, one launch
    counted."""
    w, carry, cond, lpc, temp = _flagship_inputs(dev, 2, batch=batch)
    temp = -torch.ones_like(temp)
    before = sampler_frames.launches
    kc, ks = sampler_frames(w, carry, cond, lpc, temp, None)
    pc, ps = sampler_frames_plain(w, carry, cond, lpc, temp, None)
    torch.cuda.synchronize()
    assert sampler_frames.launches == before + 1
    assert tuple(kc[3].shape) == (batch,)
    assert torch.equal(kc[3], pc[3])
    torch.testing.assert_close(ks, ps, atol=1e-5, rtol=0)
    for a, b in zip(kc[:3], pc[:3]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bunch", [1, 8])
def test_sampler_kernel_plan_keeps_shipped_weights_resident(dev, bunch):
    """For a shipped checkpoint every split weight stays in the cluster's
    shared memory, and the card runs at least one such cluster."""
    name = "vocoder_speech.npz" if bunch == 1 else \
        f"vocoder_speech_b{bunch}.npz"
    w, _, cond, lpc, _ = _flagship_inputs(dev, 1, name=name)
    plan = kernel_plan(w, bunch, cond.shape[2], lpc.shape[2])
    assert plan["gru_a_tiles_resident"] and plan["gru_b_wx_resident"] \
        and plan["heads_resident"]
    assert plan["cluster"] == 8 and plan["max_active_clusters"] >= 1
    assert plan["resident_bytes"] < plan["smem_bytes"] <= 232448


def _narrow_model(dev, bunch, ga, gb, masked):
    """A seeded model at widths that the [16 x 128] tile does not divide
    (every ragged tile kept), or a divisible one with a random tile mask."""
    model = tnet.LPCNetModel(bunch=bunch, gru_a_units=ga, gru_b_units=gb,
                             cond_dim=12, embed_dim=8)
    rng = np.random.default_rng(ga + bunch)
    L = 256

    def n(*shape, s=0.3):
        return (rng.normal(size=shape) * s).astype(np.float32)

    E, nE = 8, 2 * bunch + 1
    # At the full width a random recurrent matrix of scale 0.2 has a gain of
    # 4 per step: the state would amplify last-bit differences of the sums
    # past any tolerance.  Unit gain there.
    s_wh = 0.2 if ga <= 128 else 1.0 / np.sqrt(ga)
    p = {"emb_sig": n(L, E), "emb_pred": n(L, E), "emb_exc": n(L, E),
         "gru_a_wx": n(nE * E + 12, 3 * ga), "gru_a_bx": n(3 * ga),
         "gru_a_wh": n(ga, 3 * ga, s=s_wh), "gru_a_bh": n(3 * ga),
         "gru_b_wx": n(ga + 12, 3 * gb), "gru_b_bx": n(3 * gb),
         "gru_b_wh": n(gb, 3 * gb), "gru_b_bh": n(3 * gb)}
    for j in range(bunch):
        sfx = "" if j == 0 else f"_b{j}"
        for h in (1, 2):
            p[f"fc_out{h}_w{sfx}"] = n(gb, L)
            p[f"fc_out{h}_g{sfx}"] = 1.0 + n(L, s=0.2)
        p[f"fc_out_b{sfx}"] = n(L, s=0.2)
        if j:
            p[f"emb_sig_l{j}"], p[f"emb_exc_l{j}"] = n(L, E), n(L, E)
            p[f"bunch_exc_emb_b{j}"] = n(L, L, s=0.1)
            p[f"bunch_pred_emb_b{j}"] = n(L, L, s=0.1)
    if masked:
        keep = rng.random((ga // 16, 3 * ga // 128)) < 0.4
        keep[0] = True
        p["gru_a_mask"] = np.repeat(np.repeat(keep, 16, 0), 128, 1).astype(
            np.float32)
    p = {k: torch.from_numpy(v).to(dev) for k, v in p.items()}
    w = tnet.sampler_weights_for(model, p)
    B, T = 2, 3
    carry = (torch.from_numpy(n(B, ga)).to(dev),
             torch.from_numpy(n(B, gb)).to(dev),
             torch.from_numpy(n(B, 16, s=0.1)).to(dev),
             torch.from_numpy(rng.integers(0, L, (B, bunch))).to(dev))
    if bunch == 1:
        carry = carry[:3] + (carry[3][:, 0],)
    return (w, carry, torch.from_numpy(n(T, B, 12, s=0.5)).to(dev),
            torch.from_numpy(n(T, B, 16, s=0.05)).to(dev))


@pytest.mark.parametrize("bunch, ga, gb, masked", [
    (1, 20, 8, False), (2, 40, 12, False), (4, 72, 8, False),
    (8, 20, 8, False), (1, 128, 16, True), (2, 128, 16, True),
    (1, 384, 32, False), (8, 384, 32, False)])
def test_sampler_kernel_on_narrow_ragged_models(dev, bunch, ga, gb, masked):
    """Widths that 16 and 128 do not divide, fewer units than blocks (some
    blocks own none), a random tile mask at a small divisible width, and
    the full width unpruned (the recurrent matrix does not fit and is read
    from global memory): the one code path, greedy over three 16-sample
    frames from a random carry, two streams.  Identical excitations, PCM
    and state within 1e-5."""
    w, carry, cond, lpc = _narrow_model(dev, bunch, ga, gb, masked)
    if ga == 384:
        assert not kernel_plan(w, bunch, 12, 16, 16)["gru_a_tiles_resident"]
    temp = -torch.ones(cond.shape[:2], device=dev)
    run, plain = (sampler_frames, sampler_frames_plain) if bunch == 1 else \
        (sampler_frames_bunched, sampler_frames_bunched_plain)
    kc, ks = run(w, carry, cond, lpc, temp, None, 16)
    pc, ps = plain(w, carry, cond, lpc, temp, None, 16)
    torch.cuda.synchronize()
    assert torch.equal(kc[3], pc[3])
    torch.testing.assert_close(ks, ps, atol=1e-5, rtol=0)
    for a, b in zip(kc[:3], pc[:3]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_sampler_kernel_stochastic_matches_plain_on_same_noise(dev):
    """The kernel at S = 1 on one 50-frame block with shared noise: the
    outputs may part only after the first frame (last-bit differences feed
    back), and their RMS agree within 1 dB."""
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
    """Through the kernel at S = 1, two 50-frame calls equal one 100-frame
    call bit for bit."""
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


@pytest.mark.parametrize("bunch, batch", [(2, 1), (4, 1), (8, 1), (4, 8)])
def test_bunched_sampler_kernel_greedy_matches_plain(dev, bunch, batch):
    """K3 at full width on the shipped b2/b4/b8 checkpoints, greedy, two
    frames, one stream and eight: identical excitation history, PCM within
    1e-5, one launch counted."""
    w, carry, cond, lpc, temp = _flagship_inputs(
        dev, 2, name=f"vocoder_speech_b{bunch}.npz", batch=batch)
    temp = -torch.ones_like(temp)
    before = sampler_frames_bunched.launches
    kc, ks = sampler_frames_bunched(w, carry, cond, lpc, temp, None)
    torch.cuda.synchronize()
    assert sampler_frames_bunched.launches == before + 1
    pc, ps = sampler_frames_bunched_plain(w, carry, cond, lpc, temp, None)
    assert tuple(kc[3].shape) == (batch, bunch)
    assert torch.equal(kc[3], pc[3])
    torch.testing.assert_close(ks, ps, atol=1e-5, rtol=0)
    for a, b in zip(kc[:3], pc[:3]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bunch, batch", [(2, 1), (4, 1), (8, 1), (4, 8)])
def test_bunched_sampler_kernel_stochastic_matches_plain_on_same_noise(
        dev, bunch, batch):
    """K3 on one 50-frame block with shared noise, on each shipped bunch at
    one stream and on b4 at eight (the offline batch): no stream may part
    from the plain version before the first frame ends, and the RMS agree
    within 1 dB."""
    w, carry, cond, lpc, temp = _flagship_inputs(
        dev, 50, seed=1, name=f"vocoder_speech_b{bunch}.npz", batch=batch)
    noise = tnet.gumbel_noise(0, 0, 50, batch, dev)
    _, ks = sampler_frames_bunched(w, carry, cond, lpc, temp, noise)
    _, ps = sampler_frames_bunched_plain(w, carry, cond, lpc, temp, noise)
    diff = ((ks - ps).abs() > 1e-5).any(dim=0)
    first = int(torch.nonzero(diff)[0]) if bool(diff.any()) else ks.shape[1]
    assert first >= 160
    rms = lambda x: float(x.pow(2).mean().sqrt())  # noqa: E731
    assert abs(20 * np.log10(rms(ks) / rms(ps))) < 1.0


def test_bunched_sampler_kernel_refuses_what_it_does_not_take(dev):
    """On CUDA tensors the wrapper launches or raises: a half-precision
    weight is refused, and so is a bunch the kernel is not built for."""
    w, carry, cond, lpc, temp = _flagship_inputs(
        dev, 1, name="vocoder_speech_b2.npz")
    temp = -torch.ones_like(temp)
    with pytest.raises(TypeError):
        sampler_frames_bunched(dict(w, wh_a=w["wh_a"].half()), carry, cond,
                               lpc, temp, None)
    bad = dict(w, emb=torch.cat([w["emb"], w["emb"][:2]]))  # "bunch 3"
    with pytest.raises(ValueError):
        sampler_frames_bunched(bad, carry, cond, lpc, temp, None)


@pytest.mark.parametrize("bunch", [4, 8])
def test_bunched_chunked_equals_single_shot_on_the_card(dev, bunch):
    """Through the kernel at S = 4 and 8, two 50-frame calls equal one
    100-frame call bit for bit."""
    params = _load_params(REPO / "weights" / f"vocoder_speech_b{bunch}.npz",
                          dev)
    model = tnet.LPCNetModel.from_params(params)
    w = prepare_bunched_sampler_weights(params)
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


def _d1_features(batch, frames, seed):
    """Seeded vocoder features with voiced and unvoiced frames and periods
    32-256."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, frames, 20)).astype(np.float32) * 0.3
    feats[..., 0] -= 2.0
    feats[..., 18] = rng.uniform(-1.36, 3.12, size=(batch, frames))
    feats[..., 19] = np.where(rng.random((batch, frames)) < 0.6,
                              rng.uniform(0.0, 0.5, (batch, frames)),
                              rng.uniform(-0.5, -0.2, (batch, frames)))
    return torch.as_tensor(feats), rng


def _d1_inputs(batch, frames, seed):
    """Seeded inputs of the DSP vocoder's sample loop (D1) on the CPU:
    ``_d1_features`` through the frame-rate part, Gaussian noise, and a
    nonzero carried state."""
    feats, rng = _d1_features(batch, frames, seed)
    params = tdsp.frame_parameters(feats)
    noise = torch.as_tensor(rng.normal(size=(batch, frames, 160))
                            .astype(np.float32))
    carry = DspCarry(
        torch.as_tensor(rng.normal(size=(batch, 16)).astype(np.float32)) * .1,
        torch.as_tensor(rng.integers(-3, 200, batch).astype(np.int32)),
        torch.as_tensor(rng.normal(size=batch).astype(np.float32)) * 0.1)
    return (*params, noise), carry


@pytest.mark.parametrize("batch, frames", [(1, 260), (8, 50), (1, 1),
                                           (3, 7)])
def test_dsp_synthesis_kernel_matches_plain(dev, batch, frames):
    """D1 against its plain version, the frame-parallel algorithm in
    float32 torch (``dsp_synthesis_blocked_plain``, run on the CPU), on the
    same inputs: pcm, sig_mem, pitch phase and de-emphasis memory bit for
    bit (both round every operation once, in the same order), one
    launch."""
    inputs, carry = _d1_inputs(batch, frames, frames)
    before = dsp_synthesis.launches
    pcm, out = dsp_synthesis(*(t.to(dev) for t in inputs),
                             DspCarry(*(t.to(dev) for t in carry)))
    torch.cuda.synchronize()
    assert dsp_synthesis.launches == before + 1
    want, want_out = dsp_synthesis_blocked_plain(*inputs, carry)
    assert pcm.shape == (batch, frames * 160)
    assert torch.equal(pcm.cpu(), want)
    for a, b in zip(out, want_out):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("batch, frames", [(1, 260), (8, 50), (1, 3600)])
def test_dsp_synthesis_kernel_within_tolerance_of_the_serial_loop(
        dev, batch, frames):
    """D1 against the serial sample loop (the host-compiled
    ``dsp_synthesis_host``, bit for bit with ``dsp_synthesis_plain``) at
    the JAX parity tolerance of tests/test_torch_dsp.py: float PCM atol
    1e-5, int16 within 1 LSB, pitch phase exact, sig_mem and de-emphasis
    memory atol 1e-5 (the frame-parallel form sums the entering states in
    another order)."""
    inputs, carry = _d1_inputs(batch, frames, 3 + frames)
    pcm, out = dsp_synthesis(*(t.to(dev) for t in inputs),
                             DspCarry(*(t.to(dev) for t in carry)))
    want, want_out = dsp_synthesis_host(*inputs, carry)
    pcm = pcm.cpu()
    np.testing.assert_allclose(pcm.numpy(), want.numpy(), atol=1e-5)
    to16 = lambda x: np.clip(x.numpy() * 32767.0, -32768, 32767).astype(  # noqa: E731
        np.int16).astype(np.int32)
    assert np.abs(to16(pcm) - to16(want)).max() <= 1
    assert torch.equal(out.pitch_phase.cpu(), want_out.pitch_phase)
    np.testing.assert_allclose(out.sig_mem.cpu().numpy(),
                               want_out.sig_mem.numpy(), atol=1e-5)
    np.testing.assert_allclose(out.deemph_mem.cpu().numpy(),
                               want_out.deemph_mem.numpy(), atol=1e-5)


@pytest.mark.parametrize("batch, frames", [(1, 260), (8, 50), (3, 7)])
def test_dsp_vocode_matches_the_eager_path(dev, batch, frames):
    """``dsp_vocode``, one launch: its prologue's frame parameters and
    noise equal the eager ``frame_parameters`` and ``gaussian_noise`` on
    the card bit for bit (the same float operations in the same order, and
    torch's powf, logf, cosf and sinf are the same library calls), and its
    pcm and state equal the blocked plain version on them bit for bit."""
    feats, rng = _d1_features(batch, frames, 40 + frames)
    carry = DspCarry(
        torch.as_tensor(rng.normal(size=(batch, 16)).astype(np.float32)) * .1,
        torch.as_tensor(rng.integers(-3, 200, batch).astype(np.int32)),
        torch.zeros(batch))
    fd = feats.to(dev)
    before = (dsp_vocode.launches, dsp_synthesis.launches)
    pcm, out, params = dsp_vocode(fd, DspCarry(*(t.to(dev) for t in carry)),
                                  11, 5000, return_params=True)
    torch.cuda.synchronize()
    assert (dsp_vocode.launches, dsp_synthesis.launches) == (
        before[0] + 1, before[1] + 1)
    eager = (*tdsp.frame_parameters(fd),
             tdsp.gaussian_noise(11, batch, 5000, frames, dev))
    for a, b in zip(params, eager):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want, want_out = dsp_synthesis_blocked_plain(*(t.cpu() for t in params),
                                                 carry)
    assert torch.equal(pcm.cpu(), want)
    for a, b in zip(out, want_out):
        assert torch.equal(a.cpu(), b)


def test_dsp_vocoder_call_launches_at_most_three_kernels(dev):
    """A vocoder call on the card (LPCVocoder, 300 frames; BatchedLPCNet,
    8 x 50) launches D1 once: the wrappers count one launch and the CUDA
    profile of the call holds one D1 kernel record (at most three is the
    bound asked of a call)."""
    from torch.profiler import ProfilerActivity, profile
    feats, _ = _d1_features(8, 300, 2)
    voc = tvoc.LPCVocoder(seed=1, device=dev)
    batched = tvoc.BatchedLPCNet(batch=8, backend="dsp", seed=1, device=dev)
    voc.synthesize_frames(feats[0, :10].numpy())  # warm
    for call in (lambda: voc.synthesize_frames(feats[0].numpy()),
                 lambda: batched.synthesize_frames(feats[:, :50].numpy())):
        before = (dsp_synthesis.launches, dsp_vocode.launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        assert (dsp_synthesis.launches, dsp_vocode.launches) == (
            before[0] + 1, before[1] + 1)
        records = sum(e.count for e in prof.key_averages()
                      if "dsp_synthesis_kernel" in e.key)
        assert records == 1


def test_dsp_vocoder_chunked_equals_single_shot_on_the_card(dev):
    """Through D1 with the vocoder's own noise, 100 frames in one call
    equal 50 + 50 bit for bit, pcm and state, on two streams."""
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, 100, 20)).astype(np.float32) * 0.3
    feats[..., 19] = 0.3
    feats = torch.as_tensor(feats, device=dev)
    st = tdsp.dsp_vocoder_init(4, 2, dev)
    whole, s_whole = tdsp.dsp_synthesize_frames(st, feats)
    p1, s1 = tdsp.dsp_synthesize_frames(st, feats[:, :50])
    p2, s2 = tdsp.dsp_synthesize_frames(s1, feats[:, 50:])
    assert torch.equal(torch.cat([p1, p2], dim=1), whole)
    for a, b in zip(s2[:3], s_whole[:3]):
        assert torch.equal(a, b)
    assert s2.frame_ctr == s_whole.frame_ctr == 100


def test_dsp_synthesis_kernel_refuses_what_it_does_not_take(dev):
    """On CUDA tensors D1 launches or raises: float64 noise, an int64
    period and a noise frame of the wrong length are refused."""
    inputs, carry = _d1_inputs(1, 3, 0)
    lpc, gain, v_mix, voiced, period, noise = (t.to(dev) for t in inputs)
    carry = DspCarry(*(t.to(dev) for t in carry))
    with pytest.raises(TypeError):
        dsp_synthesis(lpc, gain, v_mix, voiced, period, noise.double(), carry)
    with pytest.raises(TypeError):
        dsp_synthesis(lpc, gain, v_mix, voiced, period.long(), noise, carry)
    with pytest.raises(ValueError):
        dsp_synthesis(lpc, gain, v_mix, voiced, period, noise[..., :80],
                      carry)


# ---- the training path -------------------------------------------------------

@lru_cache(maxsize=1)
def _speech_features():
    """[300, 20] features of 3 s of formant-synthesized speech
    (tools/make_speech_corpus.py) through the port's feature encoder on the
    CPU: cepstra of real spectral shapes, where Levinson is far worse
    conditioned than on random cepstra."""
    import importlib.util
    import sys
    from dss_tpu_torch.vocoder.features import LPCFeatureEncoder
    spec = importlib.util.spec_from_file_location(
        "make_speech_corpus", REPO / "tools" / "make_speech_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    pcm = mod.synth_utterance(np.random.default_rng(7), 3.0)
    return torch.as_tensor(
        LPCFeatureEncoder(device="cpu").compute_LPC_features(pcm))


def _lpc_features(batch, frames, seed):
    """[batch, frames + 2, 20]: even streams windows of the speech
    features, odd streams seeded random cepstra (scale 0.3, c0 - 4, as the
    serving cells draw them)."""
    speech = _speech_features()
    g = torch.Generator().manual_seed(seed)
    out = torch.randn((batch, frames + 2, 20), generator=g) * 0.3
    out[..., 0] -= 4.0
    for b in range(0, batch, 2):
        idx = (torch.arange(frames + 2) + 37 * b) % speech.shape[0]
        out[b] = speech[idx]
    return out


@pytest.mark.parametrize("batch, frames", [(1, 1), (1, 37), (1, 50),
                                           (1, 300), (15, 50), (16, 50),
                                           (16, 37), (15, 300)])
def test_lpc_kernel_matches_plain(dev, batch, frames):
    """D4 against its plain version, ``lpc_from_cepstrum_framewise``, on the
    same CUDA tensor: the taps in [L, B, 16] bit for bit, one launch, for
    the strided view the vocoder passes (features after two context
    frames) and for a time-major tensor seen as [B, L, 20]; on the random
    cepstra within 1e-5 of the library route ``lpc_from_bands
    (bands_from_cepstrum(.))`` (on the speech frames the two float32 routes
    part by up to ~1e-2: Levinson is ill-conditioned there)."""
    feats = _lpc_features(batch, frames, 100 + frames).to(dev)
    view = feats[:, 2:]
    before = lpc_frames.launches
    got = lpc_frames(view)
    torch.cuda.synchronize()
    assert lpc_frames.launches == before + 1
    assert got.shape == (frames, batch, 16) and got.is_contiguous()
    want = lpc_frames_plain(view)
    assert torch.equal(got, want)
    time_major = view.transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(lpc_frames(time_major), got)
    lib, _ = lpc_from_bands(bands_from_cepstrum(view[..., :18]))
    rand = slice(1, None, 2)
    torch.testing.assert_close(got[:, rand], lib.transpose(0, 1)[:, rand],
                               atol=1e-5, rtol=0)


def test_lpc_kernel_chunks_and_shards_equal_one_call(dev):
    """D4's taps of a frame depend on that frame alone: 100 frames equal
    50 + 50, and slots 4..7 of an 8-stream call equal the 4-stream
    shard's, bit for bit."""
    feats = _lpc_features(8, 100, 5).to(dev)[:, 2:]
    whole = lpc_frames(feats)
    halves = torch.cat([lpc_frames(feats[:, :50]),
                        lpc_frames(feats[:, 50:])])
    assert torch.equal(halves, whole)
    assert torch.equal(lpc_frames(feats[4:]), whole[:, 4:])


def test_net_synthesis_shard_rows_equal_the_batch_rows_on_the_card(dev):
    """Through ``net_synthesize_frames`` on the shipped checkpoint (D4 and
    K2): slots 4..7 of an 8-stream batch, vocoded alone from the sharded
    state, give the batch's audio for those slots bit for bit."""
    params = _load_params(REPO / "weights" / "vocoder_speech.npz", dev)
    model = tnet.LPCNetModel.from_params(params)
    w = tnet.sampler_weights_for(model, params)
    feats = _lpc_features(8, 50, 6).to(dev)[:, 2:]
    state = tnet.net_vocoder_init(model, 8, seed=2, device=dev)
    whole, _ = tnet.net_synthesize_frames(model, params, state, feats,
                                          sampler_weights=w)
    rows = {k: (v[4:] if isinstance(v, torch.Tensor) else v)
            for k, v in state._asdict().items()}
    shard = tnet.NetVocoderState(**{**rows, "slot_lo": 4, "slots": 8})
    part, _ = tnet.net_synthesize_frames(model, params, shard, feats[4:],
                                         sampler_weights=w)
    assert torch.equal(part, whole[4:])


def test_lpc_kernel_refuses_what_it_does_not_take(dev):
    """On CUDA tensors D4 launches or raises: float64 input and fewer than
    18 columns are refused; an empty block launches nothing."""
    feats = _lpc_features(2, 3, 0).to(dev)
    for bad in (feats.double(), feats[..., :17]):
        with pytest.raises(ValueError):
            lpc_frames(bad)
    before = lpc_frames.launches
    assert lpc_frames(feats[:, :0]).shape == (0, 2, 16)
    assert lpc_frames.launches == before


@pytest.mark.parametrize("name", ["vocoder_speech.npz",
                                  "vocoder_speech_b8.npz"])
def test_net_synthesis_launches_lpc_and_deemphasis_once_a_block(dev, name):
    """``net_synthesize_frames`` on the card at bunch 1 and at S = 8, two
    streams, 120 frames (blocks of 50, 50, 20): D4 and D5 once a block
    each, as many launches as the sampler's."""
    params = _load_params(REPO / "weights" / name, dev)
    model = tnet.LPCNetModel.from_params(params)
    kernel = sampler_frames if model.bunch == 1 else sampler_frames_bunched
    feats = _lpc_features(2, 120, 9).to(dev)[:, 2:]
    st = tnet.net_vocoder_init(model, 2, seed=4, device=dev)
    before = (lpc_frames.launches, deemphasis.launches, kernel.launches)
    tnet.net_synthesize_frames(model, params, st, feats)
    torch.cuda.synchronize()
    assert (lpc_frames.launches - before[0], deemphasis.launches - before[1],
            kernel.launches - before[2]) == (3, 3, 3)


@pytest.mark.parametrize("batch, n", [(1, 160), (1, 8000), (15, 8000),
                                      (16, 8000), (2, 48000), (3, 5003)])
def test_deemphasis_kernel_matches_plain(dev, batch, n):
    """D5 against its plain version (numpy) and the host loop: y and the
    carry bit for bit, one launch, from rows of a wider buffer into a
    column slice of another (the net path's layout); n = 48000 spans many
    staged tiles, and 5003 ends in a partial tile and a partial run of
    eight."""
    g = torch.Generator().manual_seed(batch * n)
    wide = torch.randn((batch, n + 5), generator=g) * 0.3
    y0 = torch.randn((batch,), generator=g)
    sig = wide.to(dev)[:, 2:2 + n]
    buf = torch.full((batch, n + 320), float("nan"), device=dev)
    before = deemphasis.launches
    last = deemphasis(sig, y0.to(dev), buf[:, 160:160 + n])
    torch.cuda.synchronize()
    assert deemphasis.launches == before + 1
    want = deemphasis_plain(wide[:, 2:2 + n].numpy(), y0.numpy())
    assert np.array_equal(buf[:, 160:160 + n].cpu().numpy(), want)
    assert np.array_equal(last.cpu().numpy(), want[:, -1])
    assert torch.isnan(buf[:, :160]).all() and torch.isnan(buf[:, -160:]).all()
    host = torch.empty((batch, n))
    host_last = deemphasis(wide[:, 2:2 + n], y0, host)
    assert np.array_equal(host.numpy(), want)
    assert torch.equal(host_last, last.cpu())


def test_deemphasis_kernel_splits_equal_one_call(dev):
    """D5 over a stream cut into calls at any samples (each from the carry
    the one before returned) and over shards of a batch gives one call's
    bits."""
    g = torch.Generator().manual_seed(3)
    sig = (torch.randn((8, 8000), generator=g) * 0.3).to(dev)
    y0 = torch.randn((8,), generator=g).to(dev)
    whole = torch.empty_like(sig)
    last = deemphasis(sig, y0, whole)
    parts, carry = torch.empty_like(sig), y0
    for a, b in ((0, 1), (1, 160), (160, 4321), (4321, 8000)):
        carry = deemphasis(sig[:, a:b], carry, parts[:, a:b])
    assert torch.equal(parts, whole) and torch.equal(carry, last)
    shard = torch.empty_like(sig[4:])
    assert torch.equal(deemphasis(sig[4:], y0[4:], shard), last[4:])
    assert torch.equal(shard, whole[4:])


def test_front_end_kernel_on_a_whole_trial_at_128_channels(dev):
    """Corpus preparation's shape: one 3040-sample trial at 128 channels
    (4 blocks of 32 lanes) from a fresh state with no carried rows, against
    the plain version: zf and the carried rows bit for bit, features
    atol 1e-5."""
    ex = HighGammaExtractor(fs=1000, nb_electrodes=128, device=dev)
    x = torch.randn((3040, 128), generator=torch.Generator().manual_seed(6))
    x = x.to(dev)
    carry = ex.framebuffer.carry(x.shape[0], x)
    assert carry.shape == (0, 128)
    before = filter_log_power.launches
    got = filter_log_power(ex.sos, x, ex.zi, carry, 10, 50)
    want = filter_log_power_plain(ex.sos, x, ex.zi, carry, 10, 50)
    torch.cuda.synchronize()
    assert filter_log_power.launches == before + 1
    assert got[0].shape == want[0].shape == (300, 128)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)


def test_bad_channel_correction_on_the_card_matches_the_cpu(dev):
    """Corner, edge and inner bad channels patched on the card as on the
    CPU; atol 1e-6 (means of up to 8 values, another order)."""
    from dss_tpu_torch.ops.car import BadChannelCorrection
    from dss_tpu_torch.utils.channels import default_layout, motor_grid, \
        speech_grid
    bcc = BadChannelCorrection([1, 19, 64, 70, 128],
                               [speech_grid(), motor_grid()],
                               default_layout())
    x = torch.randn((300, 128), generator=torch.Generator().manual_seed(7))
    want = bcc(x)
    got = bcc(x.to(dev))
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0)


def _trainer_pair(dev, kind):
    """The same seeded model at dropout 0 on the card and on the CPU."""
    from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
    from dss_tpu_torch.models.lstm import seeded_init
    from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector
    from dss_tpu_torch.train.trainer_decoder import DecoderTrainer
    from dss_tpu_torch.train.trainer_vad import VadTrainer
    if kind == "vad":
        make = lambda d: VadTrainer(seeded_init(  # noqa: E731
            UnidirectionalVoiceActivityDetector(2, 150, 64), 0), device=d)
    else:
        make = lambda d: DecoderTrainer(seeded_init(  # noqa: E731
            BidirectionalSpeechSynthesisModel(2, 100, 64), 0), device=d)
    return make(dev), make("cpu")


def _record_steps(trainer):
    """Record the gradients at every optimizer step of ``trainer``."""
    grads, step = [], trainer.optimizer.step

    def recording_step(*a, **kw):
        grads.append({k: p.grad.detach().cpu().clone()
                      for k, p in trainer.model.named_parameters()})
        return step(*a, **kw)
    trainer.optimizer.step = recording_step
    return grads


def _batch(lengths, T, E, F=None, seed=8):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    x = np.zeros((B, T, E), np.float32)
    y = np.zeros((B, T, F) if F else (B, T), np.float32)
    m = np.zeros((B, T), np.float32)
    for b, n in enumerate(lengths):
        x[b, :n] = rng.normal(size=(n, E))
        y[b, :n] = rng.normal(size=(n, F)) if F else rng.integers(0, 2, n)
        m[b, :n] = 1.0
    return x, y, m


def test_vad_tbptt_trial_on_the_card_matches_the_cpu(dev):
    """One TBPTT trial (2 x 150, six 50-frame chunks, the last all
    padding): the mean chunk loss rtol 1e-4, the first chunk's gradients
    atol 1e-5 (cuDNN's LSTM backward against the CPU's), five steps."""
    card, cpu = _trainer_pair(dev, "vad")
    grads = [_record_steps(card), _record_steps(cpu)]
    x, y, m = _batch((250, 180, 97), 300, 64)
    losses = [t.tbptt_trial(x, y, m) for t in (card, cpu)]
    assert len(grads[0]) == len(grads[1]) == 5
    torch.testing.assert_close(losses[0].cpu(), losses[1], rtol=1e-4, atol=0)
    for k in grads[1][0]:
        torch.testing.assert_close(grads[0][0][k], grads[1][0][k], atol=1e-5,
                                   rtol=0, msg=k)


def test_decoder_step_on_the_card_matches_the_cpu(dev):
    """One full-BPTT step (2 x 100 bidirectional) on a padded batch in no
    order of length: loss rtol 1e-4, gradients atol 1e-5; on the card the
    mask given as a CUDA tensor gives the same step as the host lengths."""
    card, cpu = _trainer_pair(dev, "dec")
    x, y, m = _batch((287, 300, 263), 300, 64, 20)
    losses = [t.train_step(x, y, m) for t in (card, cpu)]
    torch.testing.assert_close(losses[0].cpu(), losses[1], rtol=1e-4, atol=0)
    for (k, p), q in zip(card.model.named_parameters(),
                         cpu.model.parameters()):
        torch.testing.assert_close(p.grad.cpu(), q.grad, atol=1e-5, rtol=0,
                                   msg=k)
    again, _ = _trainer_pair(dev, "dec")
    again.train_step(x, y, torch.as_tensor(m, device=dev))
    for p, q in zip(again.model.parameters(), card.model.parameters()):
        torch.testing.assert_close(p.grad, q.grad, atol=1e-6, rtol=0)


def _recursion_inputs(B, T, seed):
    """Seeded features' per-frame LPC taps [B, T, 16] and a voiced-like
    pre-emphasized signal [B, T*160]."""
    g = torch.Generator().manual_seed(seed)
    f = torch.randn((B, T, 20), generator=g) * 0.3
    f[..., 0] -= 4.0
    lpc, _ = lpc_from_bands(bands_from_cepstrum(f[..., :18]))
    t = torch.arange(T * 160)
    period = 40 + 80 * torch.rand((B, 1), generator=g)
    sig = 0.3 * torch.sin(2 * np.pi * t[None] / period) \
        + 0.02 * torch.randn((B, T * 160), generator=g)
    return f, lpc, sig.float(), g


@pytest.mark.parametrize("mode", ["noise", "feedback"])
def test_lpc_recursion_kernel_matches_plain(dev, mode):
    """D2 at the trainer's shape (B = 32, 15 frames) in both modes, against
    its plain version on the same CUDA tensors: all four outputs bit for
    bit, one launch."""
    _, lpc, sig, g = _recursion_inputs(32, 15, 5)
    inj = torch.randint(-2, 3, sig.shape, generator=g) if mode == "noise" \
        else torch.randint(0, 256, sig.shape, generator=g)
    args = (sig.to(dev), lpc.to(dev), inj.to(dev), mode == "feedback", 24)
    before = lpc_recursion.launches
    got = lpc_recursion(*args)
    torch.cuda.synchronize()
    assert lpc_recursion.launches == before + 1
    want = lpc_recursion_plain(*args)
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name


def test_lpc_recursion_kernel_refuses_what_it_does_not_take(dev):
    _, lpc, sig, _ = _recursion_inputs(2, 2, 6)
    with pytest.raises(ValueError, match="require grad"):
        lpc_recursion(sig.to(dev).requires_grad_(), lpc.to(dev))
    with pytest.raises(ValueError, match="lpc must be"):
        lpc_recursion(sig.to(dev), lpc[:, :1].to(dev))
    with pytest.raises(TypeError, match="int64"):
        lpc_recursion(sig.to(dev), lpc.to(dev),
                      torch.zeros(sig.shape, dtype=torch.int32, device=dev))


def test_vocoder_teacher_forced_step_on_the_card_matches_the_cpu(dev):
    """The full-width teacher-forced step (GRU-A 384, B = 4, 2400 samples)
    on the card against the CPU, from the same parameters and the card's
    recursion (D2) on the same injected noise: the loss rtol 1e-5, every
    gradient rtol 1e-4 with atol 1e-4 of its tensor's largest element
    (cuDNN's GRU backward over 2400 steps sums in its own order).  The
    recursion is shared because the two devices' LPC taps differ by
    rounding, which can move a prediction across a mu-law level's edge."""
    from dss_tpu_torch.train.trainer_vocoder import VocoderTrainer
    f, lpc, sig, g = _recursion_inputs(4, 15, 7)
    noise = torch.randint(-2, 3, sig.shape, generator=g)
    params = tnet.LPCNetModel().init(torch.Generator().manual_seed(1), "cpu")
    out = {}
    rec = None
    for d in (dev, torch.device("cpu")):
        tr = VocoderTrainer(tnet.LPCNetModel(), device=d)
        p = tr.init(params)
        if rec is None:
            _, lpc_d, _ = tr._prepare_cond(p, f.to(d))
            rec = tr._recursion(sig.to(d), lpc_d, noise=noise.to(d))
            full = tr._loss(p, f.to(d), sig.to(d), noise.to(d))
        cond, _, _ = tr._prepare_cond(p, f.to(d))
        loss = tr._forward_ce(p, cond.repeat_interleave(160, 1),
                              *(r.to(d) for r in rec))
        gs = torch.autograd.grad(loss, [p[k] for k in tr.trainable])
        out[d.type] = (loss.detach().cpu(),
                       {k: v.cpu() for k, v in zip(tr.trainable, gs)})
    assert torch.equal(full.detach().cpu(), out["cuda"][0])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for k, want in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()),
                                   msg=k)


def _imported_inputs(dev, frames, seed=0):
    """A released-width imported checkpoint (tests/torch_xiph.py through
    ``params_from_datasets``) on the card and sampler inputs from its own
    frame net: the pitch table and same-padded convs over the call."""
    from torch_xiph import xiph_datasets

    from dss_tpu_torch.vocoder.interop import params_from_datasets
    params, model = params_from_datasets(xiph_datasets(seed))
    params = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn((1, frames, 20), generator=g) * 0.3
    feats[..., 0] -= 4.0
    feats = feats.to(dev)
    cond = model.condition(params, feats)
    lpc, _ = lpc_from_bands(bands_from_cepstrum(feats[..., :18]))
    state = tnet.net_vocoder_init(model, 1, device=dev)
    return (model, params, tnet.sampler_weights_for(model, params),
            (state.h_a, state.h_b, state.sig_mem, state.exc_idx),
            cond.transpose(0, 1).contiguous(),
            lpc.transpose(0, 1).contiguous())


def test_imported_checkpoint_greedy_through_the_sampler_kernel(dev):
    """An imported xiph-shaped checkpoint at the released widths (dense
    GRU-A 384, GRU-B 16, the MDense inner biases, the pitch-embedding frame
    net) greedy through the kernel at S = 1 over two frames: GRU-A's 216
    tiles do not stay resident, and excitations are identical to the plain
    version's, samples and state within 1e-5, one launch counted."""
    model, _, w, carry, cond, lpc = _imported_inputs(dev, 2)
    assert model.gru_b_units == 16 and bool(w["ib_out"].abs().max() > 0)
    plan = kernel_plan(w, 1, cond.shape[2], lpc.shape[2])
    assert not plan["gru_a_tiles_resident"]
    temp = -torch.ones(cond.shape[:2], device=dev)
    before = sampler_frames.launches
    kc, ks = sampler_frames(w, carry, cond, lpc, temp, None)
    pc, ps = sampler_frames_plain(w, carry, cond, lpc, temp, None)
    torch.cuda.synchronize()
    assert sampler_frames.launches == before + 1
    assert torch.equal(kc[3], pc[3])
    torch.testing.assert_close(ks, ps, atol=1e-5, rtol=0)
    for a, b in zip(kc[:3], pc[:3]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_reimported_b8_export_equals_the_direct_load_on_the_kernel(dev):
    """weights/vocoder_speech_b8.npz exported to the Keras layout's
    datasets and re-imported gives back every array bit for bit; greedy
    through the kernel at S = 8 over two frames, the re-imported weights
    give the direct load's samples exactly, and the plain version's within
    1e-5 with identical excitations."""
    from dss_tpu_torch.vocoder.interop import datasets_from_params, \
        native_params_from_datasets
    with np.load(REPO / "weights" / "vocoder_speech_b8.npz") as z:
        direct = {k: z[k] for k in z.files}
    back, model = native_params_from_datasets(datasets_from_params(direct))
    assert set(back) == set(direct) and model.bunch == 8
    for k in direct:
        assert back[k].dtype == direct[k].dtype
        np.testing.assert_array_equal(back[k], direct[k], err_msg=k)
    w_direct, carry, cond, lpc, _ = _flagship_inputs(
        dev, 2, name="vocoder_speech_b8.npz")
    w_back = tnet.sampler_weights_for(model, _load_params(back, dev))
    temp = -torch.ones(cond.shape[:2], device=dev)
    dc, ds = sampler_frames_bunched(w_direct, carry, cond, lpc, temp, None)
    bc, bs = sampler_frames_bunched(w_back, carry, cond, lpc, temp, None)
    pc, ps = sampler_frames_bunched_plain(w_back, carry, cond, lpc, temp,
                                          None)
    torch.cuda.synchronize()
    assert torch.equal(bs, ds) and torch.equal(bc[3], dc[3])
    assert torch.equal(bc[3], pc[3])
    torch.testing.assert_close(bs, ps, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bunch", [1, 8])
def test_sampler_kernel_levels_are_the_exact_mu_law_levels(dev, bunch):
    """With every LPC tap 0 the prediction is 0, so each sample is the
    mu-law level of its excitation.  Under noise that spreads the
    excitations over all 256 levels (50 frames), the kernel's samples at
    S = 1 and S = 8 are, bit for bit, float32 roundings of the exact
    levels sign(y) (256^|y| - 1) / 255, as are the plain version's, and
    ``mulaw_decode`` on the card gives those levels."""
    y = np.arange(256, dtype=np.float64) / 255 * 2 - 1
    levels = (np.sign(y) * np.expm1(np.abs(y) * np.log(256.0)) / 255
              ).astype(np.float32)
    from dss_tpu_torch.vocoder.mulaw import mulaw_decode
    np.testing.assert_array_equal(
        mulaw_decode(torch.arange(256, device=dev)).cpu().numpy(), levels)
    name = "vocoder_speech.npz" if bunch == 1 else \
        f"vocoder_speech_b{bunch}.npz"
    w, carry, cond, lpc, _ = _flagship_inputs(dev, 50, name=name)
    lpc = torch.zeros_like(lpc)
    temp = torch.ones(cond.shape[:2], device=dev)
    noise = 100.0 * torch.randn(
        (50, 160, 1, 256), generator=torch.Generator().manual_seed(3)).to(dev)
    kernel, plain = (sampler_frames, sampler_frames_plain) if bunch == 1 \
        else (sampler_frames_bunched, sampler_frames_bunched_plain)
    _, ks = kernel(w, carry, cond, lpc, temp, noise)
    _, ps = plain(w, carry, cond, lpc, temp, noise)
    ks, ps = ks[0].cpu().numpy(), ps[0].cpu().numpy()
    seen = np.abs(ks[:, None] - levels[None]).argmin(1)
    assert len(set(seen.tolist())) == 256
    np.testing.assert_array_equal(ks, levels[seen])
    np.testing.assert_array_equal(ps, ks)


def test_contamination_surrogates_on_the_card_match_numpy(dev):
    """64 surrogates of a 12 s, 32-channel contaminated day on the card:
    the first eight within rtol 1e-4 of the numpy plain version (the
    measure of the rolled audio spectrogram), all of them within rtol
    1e-4 of the same batched path on the CPU."""
    from dss_tpu_torch.eval import contamination as tc
    rng = np.random.default_rng(5)
    T = 12000
    env = (np.sin(2 * np.pi * np.arange(T) / 4000) > 0).astype(float)
    audio = rng.normal(size=T) * (0.1 + env)
    ecog = rng.normal(size=(T, 32))
    ecog[:, 3] += 5.0 * audio
    a, b = tc.day_spectrograms(ecog, audio, 1000)
    got = tc.surrogate_measures(a, b, 25, 64, device=dev)
    cpu = tc.surrogate_measures(a, b, 25, 64, device="cpu")
    np.testing.assert_allclose(got, cpu, rtol=1e-4)
    for s, g in zip(tc.surrogate_shifts(len(a), 25, 64)[:8], got[:8]):
        want, _ = tc.lagged_correlation_measure(np.roll(a, int(s), axis=0),
                                                b, 25)
        np.testing.assert_allclose(g, want, rtol=1e-4)


def test_sampler_kernel_greedy_at_sixteen_streams(dev):
    """K2 at the scale-out path's widest tested batch, 16 streams (two
    clusters' waves on some cards): greedy over two frames, identical
    excitations, PCM and state within 1e-5."""
    w, carry, cond, lpc, temp = _flagship_inputs(dev, 2, seed=4, batch=16)
    temp = -torch.ones_like(temp)
    kc, ks = sampler_frames(w, carry, cond, lpc, temp, None)
    pc, ps = sampler_frames_plain(w, carry, cond, lpc, temp, None)
    torch.cuda.synchronize()
    assert tuple(kc[3].shape) == (16,)
    assert torch.equal(kc[3], pc[3])
    torch.testing.assert_close(ks, ps, atol=1e-5, rtol=0)
    for a, b in zip(kc[:3], pc[:3]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_bunched_sampler_kernel_b8_at_eight_streams(dev):
    """K3 on the shipped b8 checkpoint at eight streams (the sharded word
    unit's batch): greedy over two frames, identical excitations, PCM
    within 1e-5."""
    w, carry, cond, lpc, temp = _flagship_inputs(
        dev, 2, seed=5, name="vocoder_speech_b8.npz", batch=8)
    temp = -torch.ones_like(temp)
    kc, ks = sampler_frames_bunched(w, carry, cond, lpc, temp, None)
    pc, ps = sampler_frames_bunched_plain(w, carry, cond, lpc, temp, None)
    torch.cuda.synchronize()
    assert tuple(kc[3].shape) == (8, 8)
    assert torch.equal(kc[3], pc[3])
    torch.testing.assert_close(ks, ps, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["vocoder_speech.npz",
                                  "vocoder_speech_b8.npz"])
def test_sharded_word_unit_chunked_equals_single_shot_on_the_card(dev, name):
    """ShardedFusedDecoderVocoder at world 1 on the card (a world-1 NCCL
    group), eight distinct slots on the shipped checkpoint: chunked
    emission equals the single-shot path bit for bit for every slot, each
    slot T_i x 160 samples, the sampler launched once a chunk."""
    import torch.distributed as dist

    from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
    from dss_tpu_torch.runtime.units import ShardedFusedDecoderVocoder, \
        ShardedFusedDecoderVocoderSettings

    lengths = [60, 30, 55, 100, 42, 77, 50, 88]
    rng = np.random.default_rng(3)
    segs = [rng.normal(size=(T, 64)).astype(np.float32) for T in lengths]
    kernel = sampler_frames if name == "vocoder_speech.npz" \
        else sampler_frames_bunched

    def unit(chunked):
        u = ShardedFusedDecoderVocoder()
        u.apply_settings(ShardedFusedDecoderVocoderSettings(
            path_to_model_weights=None,
            model=BidirectionalSpeechSynthesisModel,
            params=dict(nb_layer=2, nb_hidden_units=100, nb_electrodes=64),
            vocoder_weights=str(REPO / "weights" / name), streams=8,
            slot_feeder=lambda n, t: segs[1:], chunk_emission=chunked,
            device="cuda"))
        u.initialize()
        return u

    try:
        chunked, single = unit(True), unit(False)
        assert dist.get_backend() == "nccl" and chunked._world == 1
        before = kernel.launches
        lpc_c, a0, pending, Ts = chunked._decode_head(segs[0])
        parts = [a0] + [chunked._read_chunk(f, k, Ts)
                        for k, f in enumerate(pending, start=1)]
        assert kernel.launches == before + 2
        lpc_s, a0_s = single._decode_and_vocode(segs[0])
        np.testing.assert_array_equal(lpc_c, lpc_s)
        np.testing.assert_array_equal(np.concatenate(parts), a0_s)
        assert len(a0_s) == lengths[0] * 160
        for i in range(1, 8):
            got = np.concatenate(chunked._bg_parts[i])
            np.testing.assert_array_equal(got, single.slot_audio[i])
            assert len(got) == lengths[i] * 160
        for u in (chunked, single):
            u.shutdown()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _decoder(dev, H=100, E=64, seed=0, L=2, F=20):
    """A seeded decoder in eval mode; by default the deployed widths (2 x
    100 bidirectional, 64 inputs, 20 outputs)."""
    from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
    from dss_tpu_torch.models.lstm import seeded_init
    return seeded_init(BidirectionalSpeechSynthesisModel(L, H, E,
                                                         nb_outputs=F),
                       seed).to(dev).eval()


def _decoder_inputs(dev, lengths, E=64, seed=1, state=False, L=2, H=100):
    g = torch.Generator().manual_seed(seed)
    B, T = len(lengths), max(lengths)
    x = torch.randn((B, T, E), generator=g)
    for b, n in enumerate(lengths):
        x[b, n:] = 5.0  # garbage in the padding must not leak
    st = tuple((0.3 * torch.randn((2 * L, B, H), generator=g)).to(dev)
               for _ in "hc") if state else None
    return x.to(dev), st


# (E, H, L, F, lengths, initial state).  At the deployed widths: the word
# path's one-row shapes, and a ragged batch of three rows (the sharded
# unit's) from a random state.  Then other widths the plan takes, ragged
# from a random state: H = 14, lane groups of 7 columns and h slots left
# unused; E = 10 and 2H = 26, rows staged 4 bytes at a time; L = 1, one
# output buffer; L = 3; L = 4, the last layer reading the buffer the second
# layer read; H = 1 and F = 256, the narrowest recurrence and the widest
# regressor; rows of length 0.
DECODER_CASES = [(64, 100, 2, 20, [49], False),
                 (64, 100, 2, 20, [137], False),
                 (64, 100, 2, 20, [250], False),
                 (64, 100, 2, 20, [299], False),
                 (64, 100, 2, 20, [250, 137, 49], True),
                 (10, 14, 1, 5, [17, 5, 0], True),
                 (10, 13, 3, 7, [23, 0, 9], True),
                 (64, 100, 4, 20, [60, 31], True),
                 (7, 1, 2, 256, [5, 0, 3], True)]


@pytest.mark.parametrize("E, H, L, F, lengths, state", DECODER_CASES)
def test_bilstm_decoder_kernel_matches_plain(dev, E, H, L, F, lengths,
                                             state):
    """D3 against its plain version on the same CUDA tensors, the features
    padded to the next multiple of 50: features (the repeat-pad included)
    and final (h, c) bit for bit (both round each fused multiply-add and
    every other operation once, in the same order), one launch."""
    from dss_tpu_torch.ops.bilstm import bilstm_decode, \
        bilstm_decode_plain, decoder_weights, kernel_plan
    assert kernel_plan(E, H, L, F)["supported"]
    m = _decoder(dev, H=H, E=E, L=L, F=F)
    x, st = _decoder_inputs(dev, lengths, E=E, state=state, L=L, H=H)
    w = decoder_weights(m.lstm, m.regressor)
    Tp = -(-max(lengths) // 50) * 50
    before = bilstm_decode.launches
    with torch.no_grad():
        got, (h, c) = bilstm_decode(x, lengths, w, st, Tp)
    torch.cuda.synchronize()
    assert bilstm_decode.launches == before + 1
    want, (wh, wc) = bilstm_decode_plain(x, lengths, w, st, Tp)
    assert got.shape == (len(lengths), Tp, F)
    assert torch.equal(got, want)
    assert torch.equal(h, wh)
    assert torch.equal(c, wc)


@pytest.mark.parametrize("lengths", [[250], [250, 137, 49]])
def test_bilstm_decoder_kernel_matches_cudnn(dev, lengths):
    """D3 through the model's forward against cuDNN's packed run of the
    same model (run_lstm with the lengths, TF32 off), within 1e-5 at every
    valid frame and in the final state."""
    from dss_tpu_torch.models.lstm import run_lstm
    from dss_tpu_torch.ops.bilstm import bilstm_decode
    m = _decoder(dev)
    x, _ = _decoder_inputs(dev, lengths, seed=2)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            before = bilstm_decode.launches
            got, (h, c) = m(x, lengths=lengths)
            assert bilstm_decode.launches == before + 1
            y, (wh, wc) = run_lstm(m.lstm, x, None, lengths=lengths)
            want = m.regressor(y)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for b, n in enumerate(lengths):
        torch.testing.assert_close(got[b, :n], want[b, :n], atol=1e-5,
                                   rtol=0)
    torch.testing.assert_close(h, wh, atol=1e-5, rtol=0)
    torch.testing.assert_close(c, wc, atol=1e-5, rtol=0)


def test_word_units_launch_the_decoder_kernel_once_a_word(dev):
    """A word through RecurrentNeuralDecodingModel and through
    FusedDecoderVocoder's chunked head launches D3 once."""
    from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
    from dss_tpu_torch.ops.bilstm import bilstm_decode
    from dss_tpu_torch.runtime import units as tunits
    common = dict(path_to_model_weights=None,
                  model=BidirectionalSpeechSynthesisModel,
                  params=dict(nb_layer=2, nb_hidden_units=100,
                              nb_electrodes=64),
                  prewarm_frames=(100,), device="cuda")
    sep = tunits.RecurrentNeuralDecodingModel(
        tunits.RecurrentNeuralDecodingModelSettings(**common))
    fused = tunits.FusedDecoderVocoder()
    fused.apply_settings(tunits.FusedDecoderVocoderSettings(
        vocoder_weights=str(REPO / "weights" / "vocoder_speech.npz"),
        **common))
    seg = np.random.default_rng(4).normal(size=(87, 64)).astype(np.float32)
    try:
        for u in (sep, fused):
            u.initialize()
        before = bilstm_decode.launches
        sep._decode(seg)
        assert bilstm_decode.launches == before + 1
        fused._decode_head(seg)
        assert bilstm_decode.launches == before + 2
    finally:
        for u in (sep, fused):
            u.shutdown()


# The word path's decode call under the profiler, in a fresh process: a
# profiler session that follows the other card tests in one process (their
# NCCL group, their profiler sessions) may record no CUDA activity at all.
_DECODE_PROFILE = """
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
from dss_tpu_torch.models.lstm import seeded_init
from dss_tpu_torch.runtime.units import _decode_padded
dev = torch.device("cuda")
m = seeded_init(BidirectionalSpeechSynthesisModel(2, 100, 64), 0).to(dev)
seg = np.random.default_rng(4).normal(size=(87, 64)).astype(np.float32)
_decode_padded(m.eval(), seg, 87, 50, dev)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    _decode_padded(m, seg, 87, 50, dev)
    torch.cuda.synchronize()
ev = [e for e in prof.key_averages()
      if e.device_type == torch.autograd.DeviceType.CUDA]
print(sum(e.count for e in ev),
      sum(e.count for e in ev if "bilstm_decoder_kernel" in e.key))
"""


def test_word_decode_puts_at_most_five_operations_on_the_card(dev):
    """The word path's decode (``_decode_padded``) puts the copy in, the
    lengths and one D3 launch on the card: at most 5 device operations,
    where cuDNN's packed run put ~1,400."""
    import subprocess
    import sys
    out = subprocess.run([sys.executable, "-c", _DECODE_PROFILE], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    ops, kernels = map(int, out.stdout.split()[-2:])
    assert kernels == 1 and 1 <= ops <= 5, (kernels, ops)


def test_bilstm_decoder_kernel_refuses_what_it_does_not_take(dev):
    """On CUDA tensors the wrapper launches or raises: inputs that require
    grad with gradients on, float64 input, and a width above the plan's
    (which the model then routes to cuDNN)."""
    from dss_tpu_torch.ops.bilstm import bilstm_decode, decoder_weights, \
        kernel_plan
    m = _decoder(dev)
    w = decoder_weights(m.lstm, m.regressor)
    x, _ = _decoder_inputs(dev, [30])
    with pytest.raises(ValueError):
        bilstm_decode(x, [30], w)  # the parameters require grad
    with torch.no_grad():
        with pytest.raises(TypeError):
            bilstm_decode(x.double(), [30], w)
        H = kernel_plan(64, 100, 2, 20)["max_hidden"] + 1
        wide = _decoder(dev, H=H)
        assert not wide.takes_kernel(dev) and m.takes_kernel(dev)
        with pytest.raises(ValueError):
            bilstm_decode(x, [30], decoder_weights(wide.lstm, wide.regressor))
