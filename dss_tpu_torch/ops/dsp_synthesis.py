"""The DSP vocoder's synthesis (kernel D1, csrc/dsp_synthesis.cu) and its
plain PyTorch versions.

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
samples, and sig_mem, phase and y carried across frames and calls.

Two entries launch the one kernel, once a call whatever B and T:
``dsp_vocode`` takes the features [B, T, 20] and computes the frame
parameters and the noise in the kernel's prologue (what the DSP vocoder
calls on the card), ``dsp_synthesis`` takes the parameters and the noise.
The kernel runs the loop frame-parallel: each frame's map from entering to
leaving state (phase C), a serial carry pass over frames (D), then every
frame's samples rerun from its entering state (E); see the source.

Plain versions.  ``dsp_synthesis_blocked_plain`` is the kernel's algorithm
in float32 torch with every sum written as the kernel's pairwise tree: the
kernel equals it bit for bit.  ``dsp_synthesis_plain`` is the serial loop
in float32 numpy (the 16 products summed as the tree ((p0+p1)+(p2+p3))+...),
and ``dsp_synthesis_host`` the same loop compiled for the host
(csrc/dsp_synthesis_host.cpp, bit for bit with it, called through ctypes,
which releases the interpreter lock): the reference the blocked algorithm
is held to at the JAX parity tolerance (the entering states are the same
sums taken in another order).  ``dsp_vocode_plain`` is the eager
``frame_parameters`` and ``gaussian_noise`` of vocoder/dsp.py followed by
the blocked plain version.

CUDA tensors launch the kernel (or raise).  CPU tensors take the plain
versions: ``dsp_synthesis`` the host loop (it raises where it cannot be
built; nothing falls back to the numpy loop), ``dsp_vocode`` its plain
version.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda, _host
from .cepstrum_lpc import tables

FRAME = 160      # samples a frame (kFrame in the source)
ORDER = 16       # LPC taps (kOrder in the source)
PREEMPH = 0.85   # de-emphasis pole (kPreemph in the source)


class DspCarry(NamedTuple):
    """State of the sample loop, per stream."""

    sig_mem: torch.Tensor      # [B, 16] f32, newest first (pre-de-emphasis)
    pitch_phase: torch.Tensor  # [B] int32, samples until the next pulse
    deemph_mem: torch.Tensor   # [B] f32, the last de-emphasized sample


def _tree_sum(p):
    """Sum over the last axis (a power of two) as the pairwise tree
    ((p0+p1)+(p2+p3))+... that the kernel uses (numpy or torch)."""
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def _loop_inputs(lpc, gain, v_mix, voiced, period, noise):
    """The frame constants and excitations of the sample loop as float32 /
    int32 numpy arrays on the host: lpc [B, T, 16], amp (v_mix * pulse
    height, 0 where unvoiced), gain and period [B, T], and the two noise
    terms (1 - v_mix) * n and (v_mix * 0.25) * n [B, T, 160]."""
    amp = torch.where(voiced, v_mix * torch.sqrt(period.to(torch.float32)),
                      torch.zeros_like(v_mix))
    excite_a = (1.0 - v_mix)[..., None] * noise
    excite_b = (v_mix * 0.25)[..., None] * noise
    return tuple(np.ascontiguousarray(t.cpu().numpy()) for t in
                 (lpc, amp, gain, period, excite_a, excite_b))


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
    lpc, amp, gain, period, excite_a, excite_b = _loop_inputs(
        lpc, gain, v_mix, voiced, period, noise)
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


def _deemph_gain() -> float:
    """PREEMPH ** FRAME as the de-emphasis rounds it: FRAME products of a
    unit value and PREEMPH, each rounded to float32 (the de-emphasis run
    on zero input)."""
    lam, k = np.float32(1.0), np.float32(PREEMPH)
    for _ in range(FRAME):
        lam = np.float32(lam * k)
    return float(lam)


DEEMPH_FRAME = _deemph_gain()  # what a frame leaves of the entering y


def next_phase(phase: torch.Tensor, period: torch.Tensor) -> torch.Tensor:
    """The pitch phase after a frame (phase B's closed form): the frame's
    pulses fall at f = max(phase, 0), f + period, ... below FRAME, and the
    phase counts down from period - 1 after the last of them; a frame with
    no pulse takes FRAME off the phase."""
    f = torch.clamp(phase, min=0)
    rest = torch.remainder(torch.clamp(FRAME - 1 - f, min=0), period)
    return torch.where(f >= FRAME, phase - FRAME, period - 1 - rest)


def entering_phases(period: torch.Tensor, phase: torch.Tensor):
    """Phase B: the pitch phase entering each frame [B, T] and the phase
    after the last [B], serial over frames (int32)."""
    out = torch.empty_like(period)
    for t in range(period.shape[1]):
        out[:, t] = phase
        phase = next_phase(phase, period[:, t])
    return out, phase


def excitation(gain, v_mix, voiced, period, noise, phase_in) -> torch.Tensor:
    """Each frame's excitation [B, T, 160] from its entering pitch phase, in
    the sample loop's order: gain * ((t1 + (1 - v_mix) * n) + (v_mix *
    0.25) * n), t1 = v_mix * sqrt(period) at the frame's pulses when
    voiced, else 0."""
    i = torch.arange(FRAME, device=gain.device, dtype=torch.int32)
    f = torch.clamp(phase_in, min=0)[..., None]
    pulse = (i >= f) & (torch.remainder(i - f, period[..., None]) == 0)
    amp = torch.where(voiced, v_mix * torch.sqrt(period.to(torch.float32)),
                      torch.zeros_like(v_mix))
    t1 = torch.where(pulse, amp[..., None], torch.zeros_like(noise))
    excite_a = (1.0 - v_mix)[..., None] * noise
    excite_b = (v_mix * 0.25)[..., None] * noise
    return gain[..., None] * ((t1 + excite_a) + excite_b)


def _run_frames(lpc, mem, y, e, out=None):
    """The sample loop over the FRAME samples of many frames at once: taps
    lpc [..., 16], memory mem [..., 16] (newest first), de-emphasis value y
    [...], excitation e [..., 160].  Returns (mem, y) after the frame and
    writes the de-emphasized samples into ``out`` [..., 160] if given."""
    for i in range(FRAME):
        s = e[..., i] - _tree_sum(mem * lpc)
        mem = torch.cat([s[..., None], mem[..., :-1]], dim=-1)
        y = s + PREEMPH * y
        if out is not None:
            out[..., i] = y
    return mem, y


def frame_transitions(lpc: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Phase C: each frame's map from entering to leaving state, [B, T, 17,
    17], one frame independent of the others.  Row k < 16 is the memory
    and de-emphasis value after the frame from unit memory k, zero y and no
    excitation (column k of the transition Phi, then its de-emphasis weight
    w_k); row 16 the same from zero state and the frame's excitation (c,
    then cd)."""
    B, T = lpc.shape[:2]
    dev = lpc.device
    mem = torch.zeros((B, T, ORDER + 1, ORDER), device=dev)
    mem[..., :ORDER, :] = torch.eye(ORDER, device=dev)
    ex = torch.zeros((B, T, ORDER + 1, FRAME), device=dev)
    ex[..., ORDER, :] = e
    mem, y = _run_frames(lpc[..., None, :], mem,
                         torch.zeros((B, T, ORDER + 1), device=dev), ex)
    return torch.cat([mem, y[..., None]], dim=-1)


def carry_pass(rec: torch.Tensor, sig_mem: torch.Tensor,
               deemph: torch.Tensor):
    """Phase D: the state entering each frame, serial over frames.  With
    Phi[j, k] = rec[k, j], c_j = rec[16, j], w_k = rec[k, 16], cd = rec[16,
    16]: m'_j = c_j + tree_k(Phi[j, k] m_k) and d' = (cd + tree_k(w_k m_k))
    + DEEMPH_FRAME d.  Returns the entering memories [B, T, 16] and
    de-emphasis values [B, T], and the state after the last frame."""
    B, T = rec.shape[:2]
    m_in = torch.empty((B, T, ORDER), device=rec.device)
    d_in = torch.empty((B, T), device=rec.device)
    rows = rec[..., :ORDER, :].transpose(-1, -2)   # [B, T, 17, 16]: Phi; w
    m, d = sig_mem, deemph
    for t in range(T):
        m_in[:, t], d_in[:, t] = m, d
        acc = rec[:, t, ORDER] + _tree_sum(rows[:, t] * m[:, None, :])
        m, d = acc[:, :ORDER], acc[:, ORDER] + DEEMPH_FRAME * d
    return m_in, d_in, m, d


def dsp_synthesis_blocked_plain(lpc: torch.Tensor, gain: torch.Tensor,
                                v_mix: torch.Tensor, voiced: torch.Tensor,
                                period: torch.Tensor, noise: torch.Tensor,
                                carry: DspCarry):
    """Plain version of the frame-parallel kernel (phases B-E), float32
    torch with the kernel's rounding spelled out: B the entering pitch
    phases, C each frame's transition, D the carry pass over frames, E each
    frame's 160 samples rerun from its entering state.  The state returned
    is phase D's, so any split of the frames into calls gives the same
    bits.  Within rounding of the serial loop (``dsp_synthesis_plain``):
    the entering states are the same sums taken in another order.
    Arguments and results as ``dsp_synthesis``."""
    _check(lpc, gain, v_mix, voiced, period, noise, carry)
    B, T = gain.shape
    if T == 0:
        return torch.zeros((B, 0), device=gain.device), \
            DspCarry(*(t.clone() for t in carry))
    sig_mem, phase, deemph = carry
    phase_in, phase_out = entering_phases(period, phase)
    e = excitation(gain, v_mix, voiced, period, noise, phase_in)
    m_in, d_in, m, d = carry_pass(frame_transitions(lpc, e), sig_mem, deemph)
    out = torch.empty((B, T, FRAME), device=gain.device)
    _run_frames(lpc, m_in, d_in, e, out)
    pcm = torch.clamp(out, -1.0, 1.0).reshape(B, T * FRAME)
    return pcm, DspCarry(m, phase_out, d)


def dsp_synthesis_host(lpc: torch.Tensor, gain: torch.Tensor,
                       v_mix: torch.Tensor, voiced: torch.Tensor,
                       period: torch.Tensor, noise: torch.Tensor,
                       carry: DspCarry):
    """The sample loop compiled for the host (csrc/dsp_synthesis_host.cpp),
    on CPU tensors; the arguments and results of ``dsp_synthesis_plain``,
    bit for bit.  Raises if the host compiler is missing or the build
    fails.  Counts its calls in ``dsp_synthesis_host.launches``."""
    _check(lpc, gain, v_mix, voiced, period, noise, carry)
    if gain.device.type != "cpu":
        raise TypeError(f"dsp_synthesis_host: needs CPU tensors, got "
                        f"{gain.device}")
    B, T = gain.shape
    if T == 0:
        return torch.zeros((B, 0)), DspCarry(*(t.clone() for t in carry))
    lpc, amp, gain, period, excite_a, excite_b = _loop_inputs(
        lpc, gain, v_mix, voiced, period, noise)
    sig_mem, phase, y = (np.array(t.numpy(), copy=True, order="C")
                         for t in carry)
    pcm = np.empty((B, T * FRAME), np.float32)
    rc = _host.library().dss_dsp_synthesis_host(
        *(a.ctypes.data for a in (lpc, amp, gain, period, excite_a, excite_b,
                                  sig_mem, phase, y, pcm)), B, T)
    if rc != 0:
        raise RuntimeError(f"dss_dsp_synthesis_host returned {rc}")
    dsp_synthesis_host.launches += 1
    return torch.from_numpy(pcm), DspCarry(*(torch.from_numpy(a) for a in
                                             (sig_mem, phase, y)))


dsp_synthesis_host.launches = 0


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


def _check(lpc, gain, v_mix, voiced, period, noise, carry) -> None:
    """Raises on shapes, types or devices that the loops do not take."""
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


SCRATCH_PER_FRAME = FRAME + 17 * 20 + ORDER + 2  # floats (the source's layout)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernel reads the
    taps four at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(B, T, carry, params, noise, features=None, seed=0, frame_ctr=0):
    """One launch of D1 on CUDA tensors: with ``features`` the kernel's
    prologue writes the frame parameters into ``params`` (and the noise into
    ``noise`` when ``noise`` is None on entry, allocated here); else it reads
    them.  Returns (pcm, new carry, noise)."""
    dev = carry.sig_mem.device
    gen_noise = features is not None and noise is None
    if noise is None:
        noise = torch.empty((B, T, FRAME), dtype=torch.float32, device=dev)
    lpc, gain, v_mix, voiced, period = params
    sig_mem, phase, deemph = (t.contiguous() for t in carry)
    pcm = torch.empty((B, T * FRAME), dtype=torch.float32, device=dev)
    out = DspCarry(torch.empty_like(sig_mem), torch.empty_like(phase),
                   torch.empty_like(deemph))
    scratch = torch.empty(B * T * SCRATCH_PER_FRAME, dtype=torch.float32,
                          device=dev)
    rc = _cuda.library().dss_dsp_synthesis(
        None if features is None else features.data_ptr(),
        None if features is None else tables(dev).data_ptr(),
        lpc.data_ptr(), gain.data_ptr(), v_mix.data_ptr(), voiced.data_ptr(),
        period.data_ptr(), noise.data_ptr(), sig_mem.data_ptr(),
        phase.data_ptr(), deemph.data_ptr(), pcm.data_ptr(),
        out.sig_mem.data_ptr(), out.pitch_phase.data_ptr(),
        out.deemph_mem.data_ptr(), scratch.data_ptr(), int(seed) & 0xFFFFFFFF,
        int(frame_ctr) & 0xFFFFFFFF, DEEMPH_FRAME, B, T, int(gen_noise),
        _cuda.stream_ptr(sig_mem))
    _cuda.check(rc, "dsp_synthesis")
    dsp_synthesis.launches += 1
    return pcm, out, noise


def dsp_synthesis(lpc: torch.Tensor, gain: torch.Tensor, v_mix: torch.Tensor,
                  voiced: torch.Tensor, period: torch.Tensor,
                  noise: torch.Tensor, carry: DspCarry):
    """The DSP vocoder's sample loop over B streams and T frames, on given
    frame parameters and noise (the kernel without its prologue).

    lpc [B, T, 16], gain / v_mix [B, T] f32, voiced [B, T] bool, period
    [B, T] int32, noise [B, T, 160] f32 and the carry ``DspCarry``.
    Returns (pcm [B, T*160] f32 clipped to [-1, 1], new carry).  Counts the
    kernel's launches (both entries) in ``dsp_synthesis.launches``."""
    _check(lpc, gain, v_mix, voiced, period, noise, carry)
    if gain.device.type == "cpu":
        return dsp_synthesis_host(lpc, gain, v_mix, voiced, period, noise,
                                  carry)
    if gain.device.type != "cuda":
        raise TypeError(f"dsp_synthesis: needs a CUDA or CPU tensor, got "
                        f"{gain.device}")
    B, T = gain.shape
    if T == 0:
        return torch.zeros((B, 0), device=gain.device), \
            DspCarry(*(t.clone() for t in carry))
    params = (_aligned(lpc), gain.contiguous(), v_mix.contiguous(),
              voiced.to(torch.uint8).contiguous(), period.contiguous())
    pcm, out, _ = _launch(B, T, carry, params, noise.contiguous())
    return pcm, out


dsp_synthesis.launches = 0


def _check_vocode(features, carry, noise) -> None:
    """Raises on what ``dsp_vocode`` does not take."""
    if features.dim() != 3 or features.shape[-1] != 20 \
            or features.dtype != torch.float32:
        raise ValueError(f"dsp_vocode: features must be float32 [B, T, 20], "
                         f"got {features.dtype} {list(features.shape)}")
    B, T = features.shape[:2]
    sig_mem, phase, deemph = carry
    if tuple(sig_mem.shape) != (B, ORDER) or tuple(phase.shape) != (B,) \
            or tuple(deemph.shape) != (B,) or sig_mem.dtype != torch.float32 \
            or deemph.dtype != torch.float32 or phase.dtype != torch.int32:
        raise ValueError(f"dsp_vocode: the carry must be float32 [{B}, 16], "
                         f"int32 [{B}], float32 [{B}]")
    if noise is not None and (tuple(noise.shape) != (B, T, FRAME)
                              or noise.dtype != torch.float32):
        raise ValueError(f"dsp_vocode: noise must be float32 "
                         f"[{B}, {T}, {FRAME}]")
    tensors = [*carry] + ([] if noise is None else [noise])
    if any(t.device != features.device for t in tensors):
        raise ValueError("dsp_vocode: tensors on more than one device")


def dsp_vocode_plain(features: torch.Tensor, carry: DspCarry, seed: int,
                     frame_ctr: int, noise=None, return_params=False):
    """Plain version of ``dsp_vocode``: the eager ``frame_parameters`` and
    ``gaussian_noise`` of vocoder/dsp.py, then
    ``dsp_synthesis_blocked_plain``."""
    from ..vocoder.dsp import frame_parameters, gaussian_noise
    _check_vocode(features, carry, noise)
    B, T = features.shape[:2]
    if noise is None:
        noise = gaussian_noise(seed, B, frame_ctr, T, features.device)
    params = frame_parameters(features)
    pcm, out = dsp_synthesis_blocked_plain(*params, noise, carry)
    return (pcm, out, (*params, noise)) if return_params else (pcm, out)


def dsp_vocode(features: torch.Tensor, carry: DspCarry, seed: int,
               frame_ctr: int, noise=None, return_params=False):
    """The DSP vocoder's whole call in one launch: features [B, T, 20] f32
    -> (pcm [B, T*160] f32 in [-1, 1], new carry), what
    vocoder/dsp.py::dsp_synthesize_frames computes on a CUDA tensor.  The
    kernel's prologue computes the frame parameters and, unless ``noise``
    [B, T, 160] is given, the noise of streams seeded seed, seed + 1, ...
    at absolute frames frame_ctr, ...  With ``return_params`` also returns
    (lpc, gain, v_mix, voiced, period, noise) as the prologue computed
    them.  CPU tensors take ``dsp_vocode_plain``.  Counts its launches in
    ``dsp_vocode.launches`` (and the kernel's in
    ``dsp_synthesis.launches``)."""
    if features.device.type == "cpu":
        return dsp_vocode_plain(features, carry, seed, frame_ctr, noise,
                                return_params)
    if features.device.type != "cuda":
        raise TypeError(f"dsp_vocode: needs a CUDA or CPU tensor, got "
                        f"{features.device}")
    _check_vocode(features, carry, noise)
    B, T = features.shape[:2]
    dev = features.device
    params = (torch.empty((B, T, ORDER), device=dev),
              torch.empty((B, T), device=dev), torch.empty((B, T), device=dev),
              torch.empty((B, T), dtype=torch.uint8, device=dev),
              torch.empty((B, T), dtype=torch.int32, device=dev))
    if T == 0:
        pcm, out = torch.zeros((B, 0), device=dev), \
            DspCarry(*(t.clone() for t in carry))
        noise = torch.zeros((B, 0, FRAME), device=dev) if noise is None \
            else noise
    else:
        pcm, out, noise = _launch(
            B, T, carry, params, None if noise is None else noise.contiguous(),
            features=features.contiguous(), seed=seed, frame_ctr=frame_ctr)
        dsp_vocode.launches += 1
    if not return_params:
        return pcm, out
    lpc, gain, v_mix, voiced, period = params
    return pcm, out, (lpc, gain, v_mix, voiced.bool(), period, noise)


dsp_vocode.launches = 0
