"""The comparison that decides ``correct``: what the timed path produced,
at the timed sizes, against the plain reference under
``benchmarks/reference/``, each number held to its limit in
``benchmarks/limits.json``.

Session cells (one user's words):
* ``features_gap``: the largest absolute gap of a front-end feature (log
  power), over every frame of the window and every frame of every
  segment the word path received; SENTINEL when the segments (nVAD labels,
  smoothing, segment history) differ in number or length.
* ``decoder_gap``: the largest absolute gap of a decoded feature over
  every frame of every word.
* DSP vocoder: ``audio_gap_lsb``, the largest gap of a shipped int16 sample
  from the reference's, each word vocoded from the program's own entering
  state (PERF.md says why); ``state_gap``, the largest gap of an entering
  state from the one the reference leaves after the word before.
* Neural vocoder: ``sampler_disagree``, the largest share, over the
  vocoder's calls, of samples whose excitation the reference does not put
  first given the same history and noise (teacher-forced from the stream's
  start, by the judge of the configuration's bunch); ``pred_gap``, the
  largest gap of an unclipped sample from the reference's float64
  prediction plus the sample's level; ``audio_gap_lsb`` as above, from the
  program's samples.

Serving cells: ``sampler_disagree``, ``pred_gap`` and ``audio_gap_lsb``
over the first steps (from the fresh state) and a run of steps drawn from
the seed over the whole window (from the program's state there).

The control (``session_control``, ``serve_control``) puts the reference in
bfloat16 in the program's place, one stage at a time (front end and nVAD,
decoder, vocoder): that stage's outputs are the control's, computed from
what the program gave the stage, the others the program's own; each goes
through the same comparison and must come out not correct.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from benchmarks import inputs
from benchmarks.common import HERE, ROOT, SENTINEL, load_json
from benchmarks.reference import dsp as rdsp
from benchmarks.reference import frontend as rfe
from benchmarks.reference import recurrent as rrec

FRAME = 160
CHUNK = 50    # frames of a word-path vocoder call


def limits() -> Dict[str, float]:
    return {k: v["limit"] for k, v in
            load_json(HERE / "limits.json")["limits"].items()}


def _max_abs(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return SENTINEL
    return float(np.abs(a - b).max()) if a.size else 0.0


def _hold(lpc: np.ndarray, multiple: int) -> np.ndarray:
    """Frames padded to a multiple by repeating the last one."""
    n = -(-len(lpc) // multiple) * multiple
    return np.concatenate([lpc, np.repeat(lpc[-1:], n - len(lpc), 0)])


def reference_session(ctx, raw: np.ndarray, precision: str) -> dict:
    """The reference's front end, nVAD, segments and decoder over the raw
    stream (``bf16``: the control's front end and nVAD, no decoder)."""
    import torch
    traffic = ctx["traffic"]
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    per = traffic["package_size"] // rfe.HOP
    full = rfe.features(raw, precision="bf16" if precision == "bf16"
                        else "float64")
    labels = rrec.vad_labels(inputs.threshold_vad(), full, dt)[rfe.WARMUP:]
    feats = full[rfe.WARMUP:]
    n = len(raw) // traffic["package_size"]
    packets = [per - rfe.WARMUP] + [per] * (n - 1)
    segs = rrec.segments(feats, labels, packets)
    sd = inputs.decoder_weights(ctx["args"].seed,
                                **ctx["config"]["decoder_weights"])
    return dict(features=feats, labels=labels, packets=packets,
                segments=segs, lpc=None if precision == "bf16" else
                [rrec.decode(sd, s, dt) for s in segs])


def with_limits(numbers: Dict[str, float]) -> Dict[str, list]:
    lim = limits()
    return {k: [v, lim[k]] for k, v in numbers.items()}


def session(ctx, raw, prog: dict, net: bool, ref: dict) -> Dict[str, list]:
    """-> {number: [value, limit]} of the outputs ``prog`` against the
    reference's ``ref`` (``reference_session``)."""
    return with_limits(_session_numbers(ctx, ref, prog, net))


def _split(rows: np.ndarray, lengths: List[int]):
    if sum(lengths) != len(rows):
        return None
    return np.split(rows, np.cumsum(lengths)[:-1]) if lengths else []


def _session_numbers(ctx, ref, prog, net) -> Dict[str, float]:
    segs, rsegs = prog["segments"], ref["segments"]
    same = len(segs) == len(rsegs) and all(
        len(a) == len(b) for a, b in zip(segs, rsegs))
    fgap = _max_abs(prog["features"], ref["features"])
    if not same:
        fgap = SENTINEL
    elif segs:
        fgap = max(fgap, max(_max_abs(a, b) for a, b in zip(segs, rsegs)))
    words = _split(prog["lpc"], [len(s) for s in segs])
    if not same or words is None:
        dgap = SENTINEL
    else:
        dgap = max((_max_abs(w, r) for w, r in zip(words, ref["lpc"])),
                   default=0.0)
    out = dict(features_gap=fgap, decoder_gap=dgap)
    if words is None or len(prog["audio"]) != len(words):
        words = None
    out.update(_net_words(ctx, words, prog) if net
               else _dsp_words(words, prog))
    return out


def _dsp_words(words, prog) -> Dict[str, float]:
    """Each word from the program's entering state: audio, and the next
    word's entering state against the reference's end state."""
    calls = prog["vocoder"]
    if words is None or len(calls) != len(words):
        return dict(audio_gap_lsb=SENTINEL, state_gap=SENTINEL)
    feats = [_hold(w, 10) for w in words]
    if any(c[4] != len(f) for c, f in zip(calls, feats)):
        return dict(audio_gap_lsb=SENTINEL, state_gap=SENTINEL)
    states = _dsp_states(calls)
    pcm, ends = rdsp.vocode(feats, states)
    agap = 0.0
    for w, p, a in zip(words, pcm, prog["audio"]):
        agap = max(agap, _max_abs(rdsp.to_int16(p[:len(w) * FRAME]), a))
    sgap = 0.0
    for prev, st in zip([rdsp.fresh_state()] + ends[:-1], states):
        if prev.phase != st.phase or prev.frame_ctr != st.frame_ctr:
            return dict(audio_gap_lsb=agap, state_gap=SENTINEL)
        sgap = max(sgap, _max_abs(prev.sig_mem, st.sig_mem),
                   abs(prev.deemph - st.deemph))
    return dict(audio_gap_lsb=agap, state_gap=sgap)


def _dsp_states(calls):
    """The DSP vocoder's entering states as the probe kept them."""
    return [rdsp.DspState(c[0].cpu().numpy().astype(np.float32),
                          int(c[1]), float(c[2]), int(c[3])) for c in calls]


def _judge_of(ctx):
    """The neural judge of the configuration's bunch: the bunch-1 module
    at 1, the bunched module above it."""
    if ctx["config"]["vocoder"]["bunch"] > 1:
        from benchmarks.reference import lpcnet_bunched as rnet
    else:
        from benchmarks.reference import lpcnet as rnet
    return rnet


def _net_params(ctx, device):
    from benchmarks.reference import lpcnet as rnet
    path = ROOT / ctx["config"]["ini"]["Decoding"]["vocoder_weights"]
    return rnet.load(str(path), device)


def _net_words(ctx, words, prog) -> Dict[str, float]:
    """The word path's vocoder stream, teacher-forced from its start."""
    import torch
    rnet = _judge_of(ctx)
    calls = prog["vocoder"]
    bad = dict(sampler_disagree=SENTINEL, pred_gap=SENTINEL,
               audio_gap_lsb=SENTINEL)
    if words is None:
        return bad
    feats = _net_feats(words)
    if len(calls) * CHUNK != len(feats) or any(c[1] != CHUNK for c in calls):
        return bad
    if not calls:
        return dict(sampler_disagree=0.0, pred_gap=0.0, audio_gap_lsb=0.0)
    sig = torch.cat([c[0] for c in calls], dim=1)
    dev = sig.device
    v = rnet.judge(_net_params(ctx, dev), torch.as_tensor(feats)[None].to(dev),
                   sig, rnet.fresh_state(1, dev), quiet_sharpen=True)
    share = v.disagree.reshape(-1, CHUNK * FRAME).float().mean(1)
    agap = max((_max_abs(a, p) for a, p in
                zip(prog["audio"], _word_audio(words, v.pcm[0].numpy()))),
               default=0.0)
    return dict(sampler_disagree=float(share.max()), pred_gap=v.pred_gap,
                audio_gap_lsb=agap)


def _net_feats(words) -> np.ndarray:
    """The words' frames as the vocoder's 50-frame chunks hold them."""
    if not words:
        return np.zeros((0, 20), np.float32)
    return np.concatenate([_hold(w, CHUNK) for w in words])


def _word_audio(words, pcm: np.ndarray) -> List[np.ndarray]:
    """The int16 audio each word ships, cut from the stream's PCM (a
    word's last chunk is held past its end and not shipped)."""
    pcm16, out, start = rdsp.to_int16(pcm), [], 0
    for w in words:
        out.append(pcm16[start:start + len(w) * FRAME])
        start += -(-len(w) // CHUNK) * CHUNK * FRAME
    return out


def session_control(ctx, raw, prog: dict, net: bool, ref: dict
                    ) -> Dict[str, Dict[str, list]]:
    """The control's readings, a stage at a time: {stage: {number:
    [value, limit]}}."""
    import torch
    low = reference_session(ctx, raw, "bf16")
    sd = inputs.decoder_weights(ctx["args"].seed,
                                **ctx["config"]["decoder_weights"])
    lpc = [rrec.decode(sd, s, torch.bfloat16) for s in prog["segments"]]
    words = _split(prog["lpc"], [len(s) for s in prog["segments"]])
    # The front end's features, cut where the reference's nVAD cuts (the
    # control's own nVAD and segmenter, at its features' gaps, would cut
    # elsewhere: an exact comparison that then reads SENTINEL).
    stages = dict(
        frontend=dict(prog, features=low["features"], segments=rrec.segments(
            low["features"], ref["labels"], ref["packets"])),
        decoder=dict(prog, lpc=np.concatenate(lpc) if lpc else prog["lpc"]),
        vocoder=(_net_control(ctx, words, prog) if net
                 else _dsp_control(words, prog)))
    return {k: session(ctx, raw, v, net, ref) for k, v in stages.items()}


def _dsp_control(words, prog) -> dict:
    """The program's words vocoded by the bfloat16 loop, word after word
    from the fresh state, in the program's place."""
    import torch
    if words is None:
        return prog
    state, calls, audio = rdsp.fresh_state(), [], []
    for w in words:
        f = _hold(w, 10)
        pcm, ends = rdsp.vocode([f], [state], precision="bf16")
        calls.append((torch.as_tensor(state.sig_mem), state.phase,
                      state.deemph, state.frame_ctr, len(f)))
        audio.append(rdsp.to_int16(pcm[0][:len(w) * FRAME]))
        state = ends[0]
    return dict(prog, vocoder=calls, audio=audio)


def _net_control(ctx, words, prog) -> dict:
    """At each position of the program's sample history, the sample the
    bfloat16 reference chooses, in the program's place."""
    import torch
    rnet = _judge_of(ctx)
    calls = prog["vocoder"]
    if words is None or not calls:
        return prog
    feats = _net_feats(words)
    if len(calls) * CHUNK != len(feats):
        return prog
    sig = torch.cat([c[0] for c in calls], dim=1)
    dev = sig.device
    state = rnet.fresh_state(1, dev)
    v = rnet.judge(_net_params(ctx, dev), torch.as_tensor(feats)[None].to(dev),
                   sig, state, quiet_sharpen=True, precision="bf16")
    own = v.samples.float()
    pcm = rnet.deemphasize(v.samples, state.deemph, "bf16")[0].numpy()
    return dict(prog, audio=_word_audio(words, pcm), vocoder=[
        (own[:, i * CHUNK * FRAME:(i + 1) * CHUNK * FRAME], CHUNK)
        for i in range(len(calls))])


def serve(ctx, runs: List[dict]) -> Dict[str, list]:
    """Each checked run of steps: {feats [B, T, 20], sig [B, T*160],
    pcm16 [B, T*160] int16 as read back, state (reference NetState)}."""
    from benchmarks.reference import lpcnet as rnet
    if not runs:   # nothing checked is not correct
        return with_limits(dict(sampler_disagree=SENTINEL, pred_gap=SENTINEL,
                                audio_gap_lsb=SENTINEL))
    worst = dict(sampler_disagree=0.0, pred_gap=0.0, audio_gap_lsb=0.0)
    step = ctx["traffic"]["frames"] * FRAME
    for r in runs:
        v = rnet.judge(_net_params(ctx, r["sig"].device), r["feats"],
                       r["sig"], r["state"])
        share = v.disagree.reshape(v.disagree.shape[0], -1, step).float() \
            .mean(-1)
        worst["sampler_disagree"] = max(worst["sampler_disagree"],
                                        float(share.max()))
        worst["pred_gap"] = max(worst["pred_gap"], v.pred_gap)
        worst["audio_gap_lsb"] = max(worst["audio_gap_lsb"], _max_abs(
            rdsp.to_int16(v.pcm.numpy()), r["pcm16"]))
    return with_limits(worst)


def serve_control(ctx, runs: List[dict]) -> Dict[str, Dict[str, list]]:
    """The bfloat16 reference's samples, at each position of the
    program's history, and their PCM in the program's place."""
    from benchmarks.reference import lpcnet as rnet
    low = []
    for r in runs:
        v = rnet.judge(_net_params(ctx, r["sig"].device), r["feats"],
                       r["sig"], r["state"], precision="bf16")
        pcm = rnet.deemphasize(v.samples, r["state"].deemph, "bf16")
        low.append(dict(r, sig=v.samples.float(),
                        pcm16=rdsp.to_int16(pcm.numpy())))
    return {"vocoder": serve(ctx, low)}
