"""Runner of batched vocoder serving: the serving step of
``dss_tpu_torch.apps.serve_multichip`` at a world of one (no collective in
the step), closed loop: ``net_synthesize_frames`` over B streams x F frames
a step, the int16 PCM read back to the host after every step, as a server
shipping audio would.  The features come from a pool drawn on the device
from the seed and rotate from step to step; every stream's state carries
over the whole window.  A probe around the sampler keeps the samples of
the steps the check reads: the first ones, from the fresh state, and a run
of as many drawn from the seed over the whole window (a reservoir of one
over every whole run after the first, so each is as likely)."""

from __future__ import annotations

import collections
import time

import numpy as np

from benchmarks import checks
from benchmarks.common import ROOT, Probes

CHECKED = 3   # steps in each checked run


def feature_pool(seed: int, traffic: dict, device):
    """[pool, B, F, 20] features on the device: normal at the mix's scale,
    the energy cepstrum c0 offset to speech level."""
    import torch
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    shape = (traffic["pool"], traffic["streams"], traffic["frames"], 20)
    x = torch.randn(shape, generator=g, device=device) * \
        traffic["feature_scale"]
    x[..., 0] += traffic["c0_offset"]
    return x


def run(ctx) -> dict:
    import torch

    from dss_tpu_torch.ops import sampler
    from dss_tpu_torch.vocoder.lpcnet import _load_params
    from dss_tpu_torch.vocoder.net import LPCNetModel, \
        net_synthesize_frames, net_vocoder_init, sampler_weights_for

    from benchmarks.reference.lpcnet import NetState, fresh_state

    config, traffic, args = ctx["config"], ctx["traffic"], ctx["args"]
    dev = torch.device(ctx["device"])
    weights = ROOT / config["ini"]["Decoding"]["vocoder_weights"]
    params = _load_params(str(weights), dev)
    model = LPCNetModel.from_params(params)
    w = sampler_weights_for(model, params)
    B = traffic["streams"]
    pool = feature_pool(args.seed, traffic, dev)
    rng = np.random.default_rng([int(args.seed), 4])

    def step(state, feats):
        pcm, state = net_synthesize_frames(model, params, state, feats,
                                           sampler_weights=w)
        pcm16 = torch.clamp(pcm * 32767.0, -32768, 32767).to(torch.int16)
        finite = torch.isfinite(pcm).all(dim=1)
        return pcm16.cpu().numpy(), finite.cpu().numpy(), state

    # Set-up: the sampler's weight layout and every launch at this shape.
    step(net_vocoder_init(model, batch=B, device=dev), pool[0])
    torch.cuda.synchronize() if dev.type == "cuda" else None

    probes = Probes()
    probes.wrap(sampler, "sampler_frames", lambda a, kw, out: out[1])
    sigs = probes.calls["sampler_frames"]
    state = net_vocoder_init(model, batch=B, device=dev)
    trace = ctx["trace"]
    first, ring = [], collections.deque(maxlen=CHECKED)
    drawn, whole = None, 0
    walls, failed, k = [], 0, 0
    setup_end = time.perf_counter()
    if trace is not None:
        trace.start()
    t0 = time.perf_counter()
    try:
        # The window lasts its seconds, and at least the steps of one
        # checked run.
        while time.perf_counter() - t0 < args.seconds or k < CHECKED:
            ts = time.perf_counter()
            state_in = state
            pcm16, finite, state = step(state, pool[k % len(pool)])
            walls.append(time.perf_counter() - ts)
            failed += int(B - finite.sum())
            kept = (k, state_in, sigs[-1], pcm16)
            sigs.clear()
            if k < CHECKED:
                first.append(kept)
            ring.append(kept)
            if k >= 2 * CHECKED - 1:   # a whole run after the first ends
                whole += 1
                if rng.random() * whole < 1.0:
                    drawn = list(ring)
            k += 1
        window = time.perf_counter() - t0
    finally:
        probes.restore()
    if trace is not None:
        trace.stop()
    summary = trace.finish(window) if trace is not None else None
    out = dict(
        kind="serve", setup_s=setup_end - ctx["t_start"], window_s=window,
        steps=k, streams=B, frames=traffic["frames"], step_wall_s=walls,
        audio_s=k * B * traffic["frames"] * 0.01, attempted=k * B,
        failed=failed, trace=summary)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    runs = []
    for kept in (first, drawn):
        if not kept or len(kept) < CHECKED:
            continue
        st = kept[0][1]
        start = (fresh_state(B, dev) if kept[0][0] == 0 else NetState(
            st.h_a, st.h_b, st.sig_mem, st.exc_idx, st.feat_mem, st.deemph,
            st.frame_ctr, st.slot_lo, st.slots))
        runs.append(dict(
            feats=torch.cat([pool[j % len(pool)] for j, *_ in kept], dim=1),
            sig=torch.cat([x[2] for x in kept], dim=1),
            pcm16=np.concatenate([x[3] for x in kept], axis=1),
            state=start))
    del first, drawn, ring, state
    t = time.perf_counter()
    out["checks"] = checks.serve(ctx, runs)
    out["check_s"] = time.perf_counter() - t
    if args.control:
        out["control"] = checks.serve_control(ctx, runs)
    return out
