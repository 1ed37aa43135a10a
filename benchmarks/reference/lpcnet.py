"""Plain reference of the LPCNet sample-rate network at bunch 1 (Valin &
Skoglund, ICASSP 2019, arXiv:1810.11846), judged teacher-forced.

Each 16 kHz sample: the prediction pred = -sum(lpc * last 16 samples); GRU-A
(reset-after, masked recurrent matrix) over the embeddings of mu-law(last
sample), mu-law(pred) and the last excitation, with the frame's
conditioning; GRU-B over GRU-A's state and the conditioning; two tanh heads
give 256 logits; the excitation is the argmax of logits * temperature +
capped Gumbel noise (a counter hash of stream seed, absolute frame, position
and slot); sample = pred + mu-law level.  The frame-rate network: two
causal 3-tap convolutions and two dense layers, tanh each.

``judge`` does not decode.  It takes the samples the program's sampler
produced (before de-emphasis), the excitation behind each (the mu-law level
nearest sample - pred, pred the reference's own float64 prediction), runs
the two GRUs over that history in one call each, and asks at every sample
whether the reference, given the same history and noise, puts the
program's excitation first.  It also reads how far each unclipped sample
lies from pred + its level (``pred_gap``: a prediction the program got
wrong by less than half a mu-law step moves no excitation, only this).
The prediction whose mu-law index GRU-A embeds is taken as the program
rounded it (sample less level), so that a float32 sum summed in another
order does not move the index across a level's edge.  A sample at the
clip (|s| = 1) agrees if the reference's choice reaches the clip too, and
that choice stands for its excitation in the history.  It also
de-emphasizes the samples (float64) into the PCM the program should have
shipped.  Plain PyTorch with TF32 off; ``precision="bf16"`` is the
control: weights, layer inputs, the prediction, the samples and the
de-emphasized PCM rounded to bfloat16; its ``samples`` (its own choice's
sample at each position of the program's history) stand in the program's
place.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from scipy import signal

from . import lpc as L
from .precision import no_tf32

NOISE_CAP = 8.0
CONTEXT = 4                   # frames of left context of the two convs
QUIET_C0, QUIET_GAIN = -12.0, 0.5
SEED = 0                      # the noise's stream seed, as the program's
BLOCK_FRAMES = 100            # frames of noise and logits held at once


class Verdict(NamedTuple):
    disagree: torch.Tensor  # [B, N] bool: excitation not put first
    pcm: torch.Tensor       # [B, N] float64 on the CPU: the samples
    #                         de-emphasized and clipped
    pred_gap: float         # largest |sample - (pred + level)|, unclipped
    samples: torch.Tensor   # [B, N] float64: the reference's own choice's
    #                         sample at each position of that history


class NetState(NamedTuple):
    """Entering state of B streams."""
    h_a: torch.Tensor       # [B, 384]
    h_b: torch.Tensor       # [B, 32]
    sig_mem: torch.Tensor   # [B, 16], newest first
    exc: torch.Tensor       # [B] excitation index
    feat_mem: torch.Tensor  # [B, 4, 20] frames before the first
    deemph: torch.Tensor    # [B] last de-emphasized sample
    frame_ctr: int          # absolute index of the first frame
    slot_lo: int = 0        # the rows' place in the batch the noise is
    slots: int = 0          # drawn for (0: the B rows are the batch)


def fresh_state(batch: int, device) -> NetState:
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return NetState(z(batch, 384), z(batch, 32), z(batch, 16),
                    torch.full((batch,), 128, dtype=torch.long,
                               device=device), z(batch, CONTEXT, 20), z(batch), 0)


def load(path: str, device) -> Dict[str, torch.Tensor]:
    with np.load(path) as f:
        return {k: torch.as_tensor(f[k], device=device) for k in f.files}


def gumbel(seed: int, first_frame: int, frames: int, batch: int, device,
           slot_lo: int = 0, slots: int = 0) -> torch.Tensor:
    """Capped Gumbel noise [frames, 160, batch, 256]."""
    slots = slots or batch
    f = torch.arange(first_frame, first_frame + frames, dtype=torch.long,
                     device=device) & L._M32
    key = L.fmix32(L.fmix32(f) ^ (int(seed) & L._M32))
    pos = torch.arange(L.FRAME, dtype=torch.long, device=device)
    slot = torch.arange(slot_lo, slot_lo + batch, dtype=torch.long,
                        device=device)
    lev = torch.arange(256, dtype=torch.long, device=device)
    j = ((pos[:, None, None] * slots + slot[None, :, None]) * 256
         + lev).reshape(-1)
    bits = L.fmix32(key[:, None] ^ j[None, :])
    u = (bits >> 8).float() * (1.0 / (1 << 24)) + 1e-9
    g = torch.clamp(-torch.log(-torch.log(u)), max=NOISE_CAP)
    return g.reshape(frames, L.FRAME, batch, 256)


def condition(p, feats_ctx: torch.Tensor) -> torch.Tensor:
    """feats after 4 frames of left context [B, T + 4, 20] -> cond
    [B, T, 128]; each convolution zero-pads 2 frames on the left."""
    def conv(x, w, b):
        n = x.shape[1]
        xp = torch.cat([x.new_zeros(x.shape[0], 2, x.shape[2]), x], dim=1)
        st = torch.cat([xp[:, i:i + n] for i in range(3)], dim=-1)
        return torch.tanh(st @ w + b)
    h = conv(conv(feats_ctx, p["conv1_w"], p["conv1_b"]),
             p["conv2_w"], p["conv2_b"])
    h = torch.tanh(h @ p["fc1_w"] + p["fc1_b"])
    return torch.tanh(h @ p["fc2_w"] + p["fc2_b"])[:, CONTEXT:]


def _gru(x, h0, wx, wh, bx, bh, span: int = 16000):
    """A reset-after GRU over x [B, N, in] from h0 [B, H], in spans of
    ``span`` steps (one cuDNN call each on the card)."""
    gru = torch.nn.GRU(wx.shape[0], wh.shape[0], batch_first=True).to(
        x.device)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(wx.T)
        gru.weight_hh_l0.copy_(wh.T)
        gru.bias_ih_l0.copy_(bx)
        gru.bias_hh_l0.copy_(bh)
        h, ys = h0[None].contiguous(), []
        for lo in range(0, x.shape[1], span):
            y, h = gru(x[:, lo:lo + span].contiguous(), h)
            ys.append(y)
    return torch.cat(ys, dim=1)


def deemphasize(s: torch.Tensor, deemph: torch.Tensor,
                precision: str = "float32") -> torch.Tensor:
    """Samples [B, N] from the last de-emphasized samples [B] -> the
    clipped PCM [B, N] float64 on the CPU (bfloat16 values for bf16)."""
    zi = deemph.to(torch.float64).cpu().numpy()[:, None] * L.PREEMPH
    y = signal.lfilter([1.0], [1.0, -L.PREEMPH],
                       s.to(torch.float64).cpu().numpy(), axis=1, zi=zi)[0]
    pcm = torch.as_tensor(np.clip(y, -1.0, 1.0))
    return _rounder(precision)(pcm)


def _rounder(precision: str):
    if precision == "bf16":
        return lambda t: t.to(torch.bfloat16).to(t.dtype)
    return lambda t: t


@torch.no_grad()
@no_tf32()
def judge(params, feats: torch.Tensor, sig: torch.Tensor, state: NetState,
          quiet_sharpen: bool = False, precision: str = "float32"
          ) -> Verdict:
    """feats [B, T, 20] and the program's samples [B, T * 160] over them
    from ``state`` -> the Verdict."""
    dev = sig.device
    rnd = _rounder(precision)
    p = {k: rnd(v.to(dev, torch.float32)) for k, v in params.items()}
    B, T, _ = feats.shape
    N = T * L.FRAME
    feats = feats.to(dev, torch.float32)
    cond = rnd(condition(p, torch.cat([state.feat_mem.to(dev), feats], 1)))
    lpc, _ = L.lpc_from_cepstrum(feats[..., :L.BANDS].to(torch.float64))
    corr = torch.clamp(feats[..., L.BANDS + 1] + 0.5, 0.0, 1.0)
    temp = 1.0 + 1.5 * corr
    if quiet_sharpen:
        temp = temp * (1.0 + torch.clamp((QUIET_C0 - feats[..., 0])
                                         * QUIET_GAIN, min=0.0))
    s = sig.to(torch.float64)
    hist = torch.cat([state.sig_mem.to(dev, torch.float64).flip(1), s], 1)
    taps = lpc.repeat_interleave(L.FRAME, dim=1)
    pred = -(hist.unfold(1, L.ORDER, 1)[:, :N].flip(2) * taps).sum(-1)
    levels = torch.as_tensor(L.MULAW_LEVELS, dtype=torch.float64,
                             device=dev)
    v = (s - pred).contiguous()
    hi = torch.searchsorted(levels, v).clamp(1, 255)
    exc = torch.where((v - levels[hi - 1]).abs() <= (levels[hi] - v).abs(),
                      hi - 1, hi)
    pcm = deemphasize(s, state.deemph, precision)
    clip = s.abs() >= 1.0
    off = torch.where(clip, 0.0, (s - (pred + levels[exc])).abs())
    pred_gap = float(off.max()) if off.numel() else 0.0
    # The prediction as the program rounded it: its sample less the level
    # (exact to half a unit of the sample), where the sample is not clipped.
    emb_pred = L.mulaw_encode(torch.where(clip, pred, s - levels[exc])
                              .float())
    prev = hist[:, L.ORDER - 1:L.ORDER - 1 + N]
    emb_sig = p["emb_sig"][L.mulaw_encode(prev.float())]
    cond_n = cond.repeat_interleave(L.FRAME, dim=1)
    temp_n = temp.repeat_interleave(L.FRAME, dim=1)
    wh = p["gru_a_wh"] * p["gru_a_mask"] if "gru_a_mask" in p \
        else p["gru_a_wh"]
    b1, b2 = p.get("fc_out1_b", 0.0), p.get("fc_out2_b", 0.0)

    def choices(exc):
        prev_exc = torch.cat([state.exc.to(dev).long()[:, None],
                              exc[:, :-1]], 1)
        x_a = rnd(torch.cat([emb_sig, p["emb_pred"][emb_pred],
                             p["emb_exc"][prev_exc], cond_n], -1))
        h_a = _gru(x_a, state.h_a.to(dev), p["gru_a_wx"], wh,
                   p["gru_a_bx"], p["gru_a_bh"])
        del x_a
        x_b = rnd(torch.cat([h_a, cond_n], -1))
        del h_a
        h_b = _gru(x_b, state.h_b.to(dev), p["gru_b_wx"], p["gru_b_wh"],
                   p["gru_b_bx"], p["gru_b_bh"])
        del x_b
        choice = torch.empty((B, N), dtype=torch.long, device=dev)
        for f0 in range(0, T, BLOCK_FRAMES):
            nf = min(BLOCK_FRAMES, T - f0)
            lo, hi = f0 * L.FRAME, (f0 + nf) * L.FRAME
            g = gumbel(SEED, state.frame_ctr + f0, nf, B, dev,
                       state.slot_lo, state.slots)
            g = g.reshape(hi - lo, B, 256).transpose(0, 1)
            hb = rnd(h_b[:, lo:hi])
            logits = (torch.tanh(hb @ p["fc_out1_w"] + b1) * p["fc_out1_g"]
                      + torch.tanh(hb @ p["fc_out2_w"] + b2)
                      * p["fc_out2_g"] + p["fc_out_b"])
            choice[:, lo:hi] = torch.argmax(
                logits * temp_n[:, lo:hi, None] + g, dim=-1)
        return choice

    # A clipped sample leaves its excitation open: any level that reaches
    # the clip.  There the reference's own choice stands for it if it
    # reaches the clip too, and the history is run again.
    for _ in range(4):
        choice = choices(exc)
        reach = torch.where(s > 0, pred + levels[choice] >= 1.0 - 1e-6,
                            pred + levels[choice] <= -1.0 + 1e-6)
        fill = torch.where(clip & reach, choice, exc)
        if not bool(clip.any()) or torch.equal(fill, exc):
            break
        exc = fill
    own = torch.clamp(rnd(rnd(pred) + levels[choice]), -1.0, 1.0)
    return Verdict(torch.where(clip, ~reach, choice != exc), pcm, pred_gap,
                   own)
