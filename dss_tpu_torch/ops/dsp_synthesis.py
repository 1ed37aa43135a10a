"""The DSP vocoder's sample loop (kernel D1, csrc/dsp_synthesis.cu) and its
plain PyTorch version.

Per stream and sample, in the order of dss_tpu/vocoder/dsp.py:67-98 (two
nested ``lax.scan``s there, which XLA runs as a serial loop; the JAX
package has no Pallas kernel for it):

    pulse_now = phase <= 0
    pulse     = sqrt(period) if pulse_now and voiced else 0
    phase     = (period if pulse_now else phase) - 1
    e         = gain * (v_mix * pulse + (1 - v_mix) * n + v_mix * 0.25 * n)
    s         = e - sum_k sig_mem[k] * lpc[k]       (the 16-tap all-pole filter)
    sig_mem   = [s, sig_mem[:-1]]
    y         = s + PREEMPH * y                     (de-emphasis)
    pcm       = clip(y, -1, 1)

with the frame's lpc, gain, v_mix, voiced and period held for its 160
samples, and sig_mem, phase and y carried across frames and calls.  Eager
PyTorch would spend ~20 launches a sample (~830,000 a 260-frame word); the
kernel runs the whole call in one launch.

Kernel and plain version round every operation once, in the same order:
the 16 products are independent and summed as a fixed pairwise tree
((p0+p1)+(p2+p3))+..., and the kernel writes each operation with
``__fmul_rn`` / ``__fadd_rn`` so that nvcc contracts nothing into an FMA.
So the two agree bit for bit, pcm and state, on the card and on the CPU.

CUDA tensors launch the kernel (or raise); CPU tensors take the plain
version.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda

FRAME = 160      # samples a frame (kFrame in the source)
ORDER = 16       # LPC taps (kOrder in the source)
PREEMPH = 0.85   # de-emphasis pole (kPreemph in the source)


class DspCarry(NamedTuple):
    """State of the sample loop, per stream."""

    sig_mem: torch.Tensor      # [B, 16] f32, newest first (pre-de-emphasis)
    pitch_phase: torch.Tensor  # [B] int32, samples until the next pulse
    deemph_mem: torch.Tensor   # [B] f32, the last de-emphasized sample


def _tree_sum(p: np.ndarray) -> np.ndarray:
    """Sum over the last axis (a power of two) as the pairwise tree
    ((p0+p1)+(p2+p3))+... that the kernel uses."""
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def dsp_synthesis_plain(lpc: torch.Tensor, gain: torch.Tensor,
                        v_mix: torch.Tensor, voiced: torch.Tensor,
                        period: torch.Tensor, noise: torch.Tensor,
                        carry: DspCarry):
    """Plain version of D1: a Python loop over the samples, every stream at
    once, in float32 numpy on the host (each operation rounded once, as
    torch's would be, at a fraction of its per-call cost).  Returns (pcm
    [B, T*160] f32 in [-1, 1], new carry) on the inputs' device."""
    B, T = gain.shape
    dev = gain.device
    if T == 0:
        return torch.zeros((B, 0), device=dev), carry
    amp = torch.where(voiced, v_mix * torch.sqrt(period.to(torch.float32)),
                      torch.zeros_like(v_mix))               # v_mix * pulse
    excite_a = ((1.0 - v_mix)[..., None] * noise).cpu().numpy()  # [B, T, 160]
    excite_b = ((v_mix * 0.25)[..., None] * noise).cpu().numpy()
    lpc, amp, gain, period = (t.cpu().numpy() for t in (lpc, amp, gain,
                                                        period))
    sig_mem, phase, y = (t.cpu().numpy() for t in carry)
    zero = np.zeros_like(amp[:, 0])
    preemph = np.float32(PREEMPH)
    out = np.empty((B, T * FRAME), np.float32)
    for t in range(T):
        a_t, amp_t, gain_t, period_t = lpc[:, t], amp[:, t], gain[:, t], \
            period[:, t]
        for i in range(FRAME):
            pulse_now = phase <= 0
            t1 = np.where(pulse_now, amp_t, zero)
            phase = np.where(pulse_now, period_t, phase) - 1
            e = gain_t * ((t1 + excite_a[:, t, i]) + excite_b[:, t, i])
            s = e - _tree_sum(sig_mem * a_t)
            sig_mem = np.concatenate([s[:, None], sig_mem[:, :-1]], axis=1)
            y = s + preemph * y
            out[:, t * FRAME + i] = y
    pcm = torch.as_tensor(np.clip(out, -1.0, 1.0), device=dev)
    return pcm, DspCarry(*(torch.as_tensor(a, device=dev)
                           for a in (sig_mem, phase.astype(np.int32), y)))


@lru_cache(maxsize=256)
def _check_shapes(lpc, gain, v_mix, voiced, period, noise, sig_mem, phase,
                  deemph):
    """Raises on shapes the kernel does not take (cached per shape set)."""
    if len(gain) != 2:
        raise ValueError(f"dsp_synthesis: gain must be [B, T], got {gain}")
    B, T = gain
    want = {"lpc": (lpc, (B, T, ORDER)), "v_mix": (v_mix, (B, T)),
            "voiced": (voiced, (B, T)), "period": (period, (B, T)),
            "noise": (noise, (B, T, FRAME)), "sig_mem": (sig_mem, (B, ORDER)),
            "pitch_phase": (phase, (B,)), "deemph_mem": (deemph, (B,))}
    for name, (got, shape) in want.items():
        if tuple(got) != shape:
            raise ValueError(f"dsp_synthesis: {name} must be {list(shape)}, "
                             f"got {list(got)}")


def dsp_synthesis(lpc: torch.Tensor, gain: torch.Tensor, v_mix: torch.Tensor,
                  voiced: torch.Tensor, period: torch.Tensor,
                  noise: torch.Tensor, carry: DspCarry):
    """The DSP vocoder's sample loop over B streams and T frames.

    lpc [B, T, 16], gain / v_mix [B, T] f32, voiced [B, T] bool, period
    [B, T] int32, noise [B, T, 160] f32 and the carry ``DspCarry``.
    Returns (pcm [B, T*160] f32 clipped to [-1, 1], new carry)."""
    sig_mem, phase, deemph = carry
    _check_shapes(lpc.shape, gain.shape, v_mix.shape, voiced.shape,
                  period.shape, noise.shape, sig_mem.shape, phase.shape,
                  deemph.shape)
    floats = (lpc, gain, v_mix, noise, sig_mem, deemph)
    if any(t.dtype != torch.float32 for t in floats) \
            or period.dtype != torch.int32 or phase.dtype != torch.int32 \
            or voiced.dtype != torch.bool:
        raise TypeError("dsp_synthesis: needs float32 lpc, gain, v_mix, "
                        "noise, sig_mem and deemph_mem, int32 period and "
                        "pitch_phase, bool voiced")
    tensors = floats + (voiced, period, phase)
    if any(t.device != gain.device for t in tensors):
        raise ValueError("dsp_synthesis: tensors on more than one device")
    if gain.device.type == "cpu":
        return dsp_synthesis_plain(lpc, gain, v_mix, voiced, period, noise,
                                   carry)
    if gain.device.type != "cuda":
        raise TypeError(f"dsp_synthesis: needs a CUDA or CPU tensor, got "
                        f"{gain.device}")
    B, T = gain.shape
    if T == 0:
        return torch.zeros((B, 0), device=gain.device), \
            DspCarry(*(t.clone() for t in carry))
    lpc, gain, v_mix, noise, sig_mem, deemph, period, phase = (
        t.contiguous() for t in (lpc, gain, v_mix, noise, sig_mem, deemph,
                                 period, phase))
    voiced = voiced.to(torch.uint8).contiguous()
    pcm = torch.empty((B, T * FRAME), dtype=torch.float32, device=gain.device)
    out = DspCarry(torch.empty_like(sig_mem), torch.empty_like(phase),
                   torch.empty_like(deemph))
    rc = _cuda.library().dss_dsp_synthesis(
        lpc.data_ptr(), gain.data_ptr(), v_mix.data_ptr(), voiced.data_ptr(),
        period.data_ptr(), noise.data_ptr(), sig_mem.data_ptr(),
        phase.data_ptr(), deemph.data_ptr(), pcm.data_ptr(),
        out.sig_mem.data_ptr(), out.pitch_phase.data_ptr(),
        out.deemph_mem.data_ptr(), B, T, _cuda.stream_ptr(gain))
    _cuda.check(rc, "dsp_synthesis")
    dsp_synthesis.launches += 1
    return pcm, out


dsp_synthesis.launches = 0
