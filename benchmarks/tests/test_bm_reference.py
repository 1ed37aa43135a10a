"""The plain reference against the program on the CPU at small sizes: each
number compared stays under its limit for the program, and the control
(the reference in bfloat16 in the program's place) goes over it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmarks import checks, common, inputs
from benchmarks.reference import dsp as rdsp
from benchmarks.reference import frontend as rfe
from benchmarks.reference import lpcnet as rnet
from benchmarks.reference import recurrent as rrec

LIM = checks.limits()
WEIGHTS = str(common.ROOT / "weights" / "vocoder_speech.npz")


def _raw(seconds=2.4, seed=0):
    traffic = common.load_json(common.HERE / "traffic" /
                               "session_keywords.json")
    return inputs.session(seed, dict(traffic, lead_s=0.5, tail_s=0.2),
                          seconds)


def test_bm_frontend_matches_the_port():
    from dss_tpu_torch.apps.decode_online import feature_transforms
    from dss_tpu_torch.ops.hga import HighGammaExtractor
    raw = _raw()
    pre, post, nf = feature_transforms(None)
    ex = HighGammaExtractor(fs=1000, nb_electrodes=nf, pre_transforms=pre,
                            post_transforms=post, device="cpu")
    st, outs = ex.init_state(), []
    for k in range(0, len(raw), 40):
        f, st = ex.packet_step(st, torch.as_tensor(raw[k:k + 40]))
        outs.append(f.numpy())
    prog = np.concatenate(outs)
    ref = rfe.features(raw)
    assert np.abs(prog - ref).max() < LIM["features_gap"]
    low = rfe.features(raw, precision="bf16")
    assert np.abs(low - ref).max() > 3 * LIM["features_gap"]


def test_bm_decoder_matches_the_port():
    from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
    sd = inputs.decoder_weights(4, c0_bias=-3.0)
    model = BidirectionalSpeechSynthesisModel(2, 100, 64)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    x = np.random.default_rng(1).normal(size=(120, 64)).astype(np.float32)
    with torch.no_grad():
        prog = model(torch.as_tensor(x)[None])[0][0].numpy()
    ref = rrec.decode(sd, x)
    assert np.abs(prog - ref).max() < LIM["decoder_gap"]
    low = rrec.decode(sd, x, torch.bfloat16)
    assert np.abs(low - ref).max() > 3 * LIM["decoder_gap"]


def test_bm_vad_labels_and_segments():
    """The threshold VAD finds the session's bursts as segments."""
    raw = _raw(seconds=4.0, seed=3)
    full = rfe.features(raw)
    labels = rrec.vad_labels(inputs.threshold_vad(), full)[rfe.WARMUP:]
    feats = full[rfe.WARMUP:]
    n = len(raw) // 40
    segs = rrec.segments(feats, labels, [1] + [4] * (n - 1))
    traffic = dict(common.load_json(common.HERE / "traffic" /
                                    "session_keywords.json"),
                   lead_s=0.5, tail_s=0.2)
    words = inputs.word_schedule(3, traffic, 4.0)
    assert len(segs) == len(words)
    for s, (a, b) in zip(segs, words):
        assert abs(len(s) - (100 + (b - a) * 100)) <= 12


def test_bm_dsp_matches_the_port():
    from dss_tpu_torch.vocoder.dsp import dsp_synthesize_frames, \
        dsp_vocoder_init
    rng = np.random.default_rng(1)
    words = [rng.normal(scale=0.4, size=(T, 20)).astype(np.float32)
             for T in (40, 70)]
    for w in words:
        w[:, 0] -= 3.0
    st, pcms, states = dsp_vocoder_init(0, 1, "cpu"), [], []
    for w in words:
        states.append(rdsp.DspState(st.sig_mem[0].numpy().copy(),
                                    int(st.pitch_phase[0]),
                                    float(st.deemph_mem[0]), st.frame_ctr))
        pcm, st = dsp_synthesize_frames(st, torch.as_tensor(w)[None])
        pcms.append(pcm[0].numpy())
    for precision, lo in (("float32", False), ("bf16", True)):
        ref, _ = rdsp.vocode(words, states, precision=precision)
        gap = max(np.abs(rdsp.to_int16(p).astype(int) - rdsp.to_int16(r))
                  .max() for p, r in zip(pcms, ref))
        if lo:
            assert gap > 3 * LIM["audio_gap_lsb"]
        else:
            assert gap <= LIM["audio_gap_lsb"]


@pytest.mark.parametrize("batch", [1, 2])
def test_bm_sampler_judge(batch):
    """The plain sampler judged teacher-forced: no disagreement; the
    bfloat16 control in its place disagrees above the limit."""
    from dss_tpu_torch.ops import sampler
    from dss_tpu_torch.vocoder.lpcnet import _load_params
    from dss_tpu_torch.vocoder.net import LPCNetModel, \
        net_synthesize_frames, net_vocoder_init, sampler_weights_for
    params = _load_params(WEIGHTS, "cpu")
    model = LPCNetModel.from_params(params)
    w = sampler_weights_for(model, params)
    f = np.random.default_rng(batch).normal(scale=0.3, size=(batch, 20, 20))
    f[..., 0] -= 2.0
    feats = torch.as_tensor(f.astype(np.float32))
    sigs = []
    orig = sampler.sampler_frames

    def probe(*a, **k):
        out = orig(*a, **k)
        sigs.append(out[1])
        return out
    sampler.sampler_frames = probe
    try:
        pcm, _ = net_synthesize_frames(
            model, params, net_vocoder_init(model, batch, device="cpu"),
            feats, sampler_weights=w, quiet_sharpen=True)
    finally:
        sampler.sampler_frames = orig
    p = rnet.load(WEIGHTS, "cpu")
    v = rnet.judge(p, feats, sigs[0], rnet.fresh_state(batch, "cpu"),
                   quiet_sharpen=True)
    assert float(v.disagree.float().mean()) <= LIM["sampler_disagree"]
    assert v.pred_gap <= LIM["pred_gap"]
    i16 = rdsp.to_int16
    assert np.abs(i16(pcm.numpy()).astype(int) - i16(v.pcm.numpy())).max() \
        <= LIM["audio_gap_lsb"]
    # The control: the bfloat16 reference's own samples at each position
    # of that history, judged in the program's place.
    low = rnet.judge(p, feats, sigs[0], rnet.fresh_state(batch, "cpu"),
                     quiet_sharpen=True, precision="bf16")
    again = rnet.judge(p, feats, low.samples.float(),
                       rnet.fresh_state(batch, "cpu"), quiet_sharpen=True)
    assert float(again.disagree.float().mean()) > LIM["sampler_disagree"]
    assert again.pred_gap > 3 * LIM["pred_gap"]


def _bunched_model(S):
    """A bunch-S checkpoint drawn from a seed at small widths, its heads'
    gains x 10 and GRU-A's update gate held towards its state, so that the
    network's state, and not the noise alone, steers each choice."""
    from dss_tpu_torch.vocoder.net import LPCNetModel
    model = LPCNetModel(gru_a_units=32, gru_b_units=16, cond_dim=16,
                        embed_dim=8, bunch=S)
    params = model.init(torch.Generator().manual_seed(S), "cpu")
    for k in params:
        if k.startswith(("fc_out1_g", "fc_out2_g")):
            params[k] = params[k] * 10.0
    params["gru_a_bx"] = params["gru_a_bx"].clone()
    params["gru_a_bx"][32:64] += 3.0
    return model, params


def _bunched_run(S, fault=None, calls=2, T=6):
    """The port's word-path vocoder (CPU: the plain bunched sampler) over T
    frames in ``calls`` calls, with one fault planted where the samples are
    produced -> (checkpoint, features, the sampler's samples, PCM)."""
    from dss_tpu_torch.ops import sampler
    from dss_tpu_torch.vocoder.net import gumbel_noise, \
        net_synthesize_frames, net_vocoder_init, sampler_weights_for
    model, params = _bunched_model(S)
    w = sampler_weights_for(model, params)
    f = np.random.default_rng(S).normal(scale=0.3, size=(1, T, 20))
    f[..., 0] -= 2.0
    feats = torch.as_tensor(f.astype(np.float32))
    noise = gumbel_noise(0, 0, T, 1, "cpu")
    if fault == "exc":   # sub-sample S/2 of every step picks another level
        noise = noise.clone()
        noise[:, S // 2::S] = noise[:, S // 2::S].roll(37, dims=-1)
    sigs, orig = [], sampler.sampler_frames_bunched

    def probe(w, carry, cond, lpc, *a, **k):
        out = orig(w, carry, cond, lpc * 1.01 if fault == "lpc" else lpc,
                   *a, **k)
        if fault == "stale_h_a":
            out = ((carry[0],) + tuple(out[0][1:]), out[1])
        sigs.append(out[1])
        return out
    sampler.sampler_frames_bunched = probe
    try:
        st, pcm, n = net_vocoder_init(model, 1, device="cpu"), [], T // calls
        for c in range(calls):
            y, st = net_synthesize_frames(
                model, params, st, feats[:, c * n:(c + 1) * n],
                sampler_weights=w, quiet_sharpen=True,
                gumbel=noise[c * n:(c + 1) * n])
            pcm.append(y)
    finally:
        sampler.sampler_frames_bunched = orig
    return params, feats, torch.cat(sigs, 1), torch.cat(pcm, 1)


@pytest.mark.parametrize("S", [2, 8])
def test_bm_bunched_judge_agrees_with_the_port(S):
    """The plain bunched sampler judged teacher-forced under the same hashed
    noise: no disagreement, the float64 prediction within 1e-6, the
    de-emphasized PCM within an int16 step; the bfloat16 control in its
    place disagrees above the limit."""
    from benchmarks.reference import lpcnet_bunched as rb
    params, feats, sig, pcm = _bunched_run(S)
    v = rb.judge(params, feats, sig, rb.fresh_state(1, "cpu"),
                 quiet_sharpen=True)
    assert not bool(v.disagree.any())
    assert v.pred_gap < 1e-6
    i16 = rdsp.to_int16
    assert np.abs(i16(pcm.numpy()).astype(int) - i16(v.pcm.numpy())).max() \
        <= 1
    low = rb.judge(params, feats, sig, rb.fresh_state(1, "cpu"),
                   quiet_sharpen=True, precision="bf16")
    again = rb.judge(params, feats, low.samples.float(),
                     rb.fresh_state(1, "cpu"), quiet_sharpen=True)
    assert float(again.disagree.float().mean()) > LIM["sampler_disagree"]
    assert again.pred_gap > 3 * LIM["pred_gap"]


@pytest.mark.parametrize("S", [2, 8])
@pytest.mark.parametrize("fault", ["exc", "stale_h_a", "lpc"])
def test_bm_bunched_judge_catches_faults(S, fault):
    """Each fault planted in the port's samples comes out not correct: a
    sub-sample's excitation changed at j = S/2 > 0 (the next sub-sample's
    correction, or the next step's lags, must take the changed one: the
    judge disagrees at j alone); GRU-A's state returned stale by each call;
    the LPC taps 1% off."""
    from benchmarks.reference import lpcnet_bunched as rb
    params, feats, sig, _ = _bunched_run(
        S, fault, calls=6 if fault == "stale_h_a" else 2)
    v = rb.judge(params, feats, sig, rb.fresh_state(1, "cpu"),
                 quiet_sharpen=True)
    share = float(v.disagree.float().mean())
    if fault == "lpc":
        assert v.pred_gap > LIM["pred_gap"]
        return
    assert share > LIM["sampler_disagree"]
    if fault == "exc":
        by = v.disagree[0].reshape(-1, S).sum(0)
        assert int(by[S // 2]) > 0.8 * (sig.shape[1] // S)
        assert int(by.sum() - by[S // 2]) <= 2
