"""Plain reference of the DSP (source-filter LPC) vocoder that the shipped
configuration runs: per 20-dim frame, the pitch features give a pulse
train and a voicing mix, the cepstrum gives 16 LPC taps and a gain
(residual energy); per 16 kHz sample the excitation runs through the
all-pole filter and de-emphasis (0.85).  Noise: 160 Gaussian values a
frame from a counter hash of (stream seed, absolute frame) and Box-Muller.

The frame-rate part runs in plain PyTorch on the CPU, the sample loop in
float32 NumPy, every stream of a batch at once.  ``precision="bf16"`` is
the control: the frame parameters in bfloat16 and every operation of the
loop rounded to bfloat16.  Its pitch period, an integer schedule, stays
as float32 rounds it, so that its pitch phase lines up with the
reference's and the check reads its state as a number.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from . import lpc as L
from .rounding import round_bf16


class DspState(NamedTuple):
    sig_mem: np.ndarray   # [16] float32, newest first
    phase: int            # samples until the next pulse
    deemph: float         # the last de-emphasized sample
    frame_ctr: int        # absolute index of the next frame


def fresh_state() -> DspState:
    return DspState(np.zeros(L.ORDER, np.float32), 0, 0.0, 0)


def noise(seed: int, first_frame: int, frames: int) -> np.ndarray:
    """[frames, 160] standard normal values of one stream."""
    f = torch.arange(first_frame, first_frame + frames,
                     dtype=torch.long) & L._M32
    key = L.fmix32(L.fmix32(f) ^ (int(seed) & L._M32))
    j = torch.arange(L.FRAME, dtype=torch.long)
    bits = L.fmix32(key[:, None] ^ j)
    u = (bits >> 8).float() * (1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(1.0 - u))[..., 0::2]
    theta = (2.0 * math.pi) * u
    return torch.cat([r * torch.cos(theta)[..., 1::2],
                      r * torch.sin(theta)[..., 1::2]], dim=-1).numpy()


def frame_parameters(feats: np.ndarray, dtype=torch.float32):
    """feats [T, 20] -> (lpc [T, 16], gain, v_mix, voiced, period)."""
    x = torch.as_tensor(np.asarray(feats, np.float32)).to(dtype)
    period, corr = L.pitch(x[:, L.BANDS], x[:, L.BANDS + 1])
    a, res = L.lpc_from_cepstrum(x[:, :L.BANDS])
    gain = torch.sqrt(torch.clamp(res, min=1e-12) / L.WINDOW * 2.0)
    v_mix = torch.clamp((corr - 0.3) / 0.5, 0.0, 1.0)
    out = [t.to(torch.float32).numpy() for t in (a, gain, v_mix)]
    return out[0], out[1], out[2], (corr > 0.3).numpy(), \
        period.to(torch.int64).numpy()


def vocode(words: List[np.ndarray], states: List[DspState], seed: int = 0,
           precision: str = "float32"):
    """Each word's frames [T_w, 20] from its own entering state ->
    (pcm per word [T_w * 160] float32 in [-1, 1], end state per word)."""
    bf16 = precision == "bf16"
    rnd = round_bf16 if bf16 else (lambda a: a)
    dtype = torch.bfloat16 if bf16 else torch.float32
    W = len(words)
    Tmax = max(len(w) for w in words)
    lpc = np.zeros((W, Tmax, L.ORDER), np.float32)
    amp = np.zeros((W, Tmax), np.float32)
    gain = np.zeros((W, Tmax), np.float32)
    period = np.ones((W, Tmax), np.int64)
    ea = np.zeros((W, Tmax, L.FRAME), np.float32)
    eb = np.zeros((W, Tmax, L.FRAME), np.float32)
    for k, (f, st) in enumerate(zip(words, states)):
        T = len(f)
        a, g, v, voiced, p = frame_parameters(f, dtype)
        if bf16:
            p = frame_parameters(f)[4]
        n = noise(seed, st.frame_ctr, T)
        lpc[k, :T], gain[k, :T], period[k, :T] = a, g, p
        amp[k, :T] = rnd(np.where(voiced, rnd(v * np.sqrt(
            p.astype(np.float32))), 0.0))
        ea[k, :T] = rnd((rnd(1.0 - v))[:, None] * n)
        eb[k, :T] = rnd((rnd(v * np.float32(0.25)))[:, None] * n)
    sig = np.stack([s.sig_mem for s in states]).astype(np.float32)
    phase = np.array([s.phase for s in states], np.int64)
    y = np.array([s.deemph for s in states], np.float32)
    ends = [None] * W
    last = {len(w) - 1: [k for k in range(W) if len(words[k]) == len(w)]
            for w in words}
    pre = np.float32(L.PREEMPH)
    zero = np.zeros(W, np.float32)
    out = np.empty((W, Tmax * L.FRAME), np.float32)
    for t in range(Tmax):
        a_t, amp_t, g_t, p_t = lpc[:, t], amp[:, t], gain[:, t], period[:, t]
        for i in range(L.FRAME):
            now = phase <= 0
            t1 = np.where(now, amp_t, zero)
            phase = np.where(now, p_t, phase) - 1
            e = rnd(g_t * rnd(rnd(t1 + ea[:, t, i]) + eb[:, t, i]))
            p = rnd(sig * a_t)
            while p.shape[-1] > 1:
                p = rnd(p[:, 0::2] + p[:, 1::2])
            s = rnd(e - p[:, 0])
            sig = np.concatenate([s[:, None], sig[:, :-1]], axis=1)
            y = rnd(s + rnd(pre * y))
            out[:, t * L.FRAME + i] = y
        for k in last.get(t, ()):
            ends[k] = DspState(sig[k].copy(), int(phase[k]), float(y[k]),
                               states[k].frame_ctr + len(words[k]))
    pcm = np.clip(out, -1.0, 1.0)
    return [pcm[k, :len(w) * L.FRAME] for k, w in enumerate(words)], ends


def to_int16(pcm: np.ndarray) -> np.ndarray:
    """Float PCM -> int16 by scale, clip and truncation toward zero."""
    return np.clip(np.asarray(pcm, np.float32) * np.float32(32767.0),
                   -32768, 32767).astype(np.int16)
