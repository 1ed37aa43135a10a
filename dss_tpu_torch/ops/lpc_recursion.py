"""The vocoder trainer's teacher-forced LPC recursion (kernel D2,
csrc/lpc_recursion.cu) and its plain PyTorch version.

Per stream and sample, in the order of dss_tpu/train/trainer_vocoder.py:
165-179 (``VocoderTrainer._recursion``, a ``lax.scan`` there; the JAX
package has no Pallas kernel for it):

    pred  = -sum_k hist[k] * lpc[k]                   (the frame's 16 taps)
    e_tgt = mulaw_encode(clip(s - pred, -1, 1))
    e_fb  = clip(e_tgt + n, 0, 255)                   noise mode
          = clip(clip(n, e_tgt - d, e_tgt + d), 0, 255)   feedback mode
    rec   = clip(pred + mulaw_decode(e_fb), -1, 1)
    hist  = [rec, hist[:-1]]

from a zero history.  ``n`` is the injected index (uniform jitter, or the
model's sampled excitation in feedback mode with drift bound ``d``).  The
outputs are data for the trainer (indices and mu-law inputs) and carry no
gradient, so the kernel is forward only and the wrapper refuses inputs that
require grad.  Eager PyTorch would spend ~12 launches a sample; the kernel
runs a batch in one launch.

Kernel and plain version round every operation once, in the same order: the
16 products summed as the pairwise tree ((p0+p1)+(p2+p3))+..., the mu-law
scale as a product with the float32 reciprocal of log1p(255), and
``mulaw_decode`` as the 256-entry table of vocoder/mulaw.py, passed to the
kernel.  So the two agree bit for bit on the card.  ``mulaw_encode``
(vocoder/mulaw.py) divides by log1p(255) instead, which may round y one
unit apart; an index can differ only where y sits on a level's edge.

CUDA tensors launch the kernel (or raise); CPU tensors take the plain
version.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..vocoder.mulaw import MULAW_LEVELS, mulaw_decode
from . import _cuda

FRAME = 160      # samples a frame (kFrame in the source)
ORDER = 16       # LPC taps (kOrder in the source)
# The float32 reciprocal of log1p(255), exact in a Python float.
INV_LOG1P_MU = float(np.float32(1.0) / np.float32(math.log1p(255.0)))


class Recursion(NamedTuple):
    """The recursion's outputs, each [B, S]."""

    pred: torch.Tensor     # f32, the LPC prediction from the drifted history
    exc_tgt: torch.Tensor  # int64, the correcting mu-law target
    exc_fb: torch.Tensor   # int64, the fed-back excitation
    sig_rec: torch.Tensor  # f32, the drifted reconstruction


_tables: Dict[str, torch.Tensor] = {}


def decode_table(device) -> torch.Tensor:
    """``mulaw_decode`` of the 256 levels on ``device`` (once per
    device)."""
    key = str(device)
    if key not in _tables:
        _tables[key] = mulaw_decode(
            torch.arange(MULAW_LEVELS, device=device)).contiguous()
    return _tables[key]


def _encode(x: torch.Tensor) -> torch.Tensor:
    """mu-law encode in the kernel's operations (int64)."""
    x = x.clamp(-1.0, 1.0)
    y = torch.sign(x) * torch.log1p(x.abs() * 255.0) * INV_LOG1P_MU
    return torch.round((y + 1.0) * 0.5 * (MULAW_LEVELS - 1)).clamp(
        0, MULAW_LEVELS - 1).long()


def _tree_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) as the pairwise tree
    ((p0+p1)+(p2+p3))+... that the kernel uses."""
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p[..., 0]


def lpc_recursion_plain(signal: torch.Tensor, lpc: torch.Tensor,
                        inject: Optional[torch.Tensor] = None,
                        feedback: bool = False, drift_bound: int = 24
                        ) -> Recursion:
    """Plain version of D2: a Python loop over the samples, every stream at
    once, in eager torch on the inputs' device."""
    B, S = signal.shape
    table = decode_table(signal.device)
    L = MULAW_LEVELS - 1
    hist = signal.new_zeros((B, ORDER))
    outs = [], [], [], []
    for i in range(S):
        pred = -_tree_sum(hist * lpc[:, i // FRAME])
        tgt = _encode((signal[:, i] - pred).clamp(-1.0, 1.0))
        n = inject[:, i] if inject is not None else torch.zeros_like(tgt)
        if feedback:
            fb = torch.minimum(torch.maximum(n, tgt - drift_bound),
                               tgt + drift_bound).clamp(0, L)
        else:
            fb = (tgt + n).clamp(0, L)
        rec = (pred + table[fb]).clamp(-1.0, 1.0)
        hist = torch.cat([rec[:, None], hist[:, :-1]], dim=1)
        for o, v in zip(outs, (pred, tgt, fb, rec)):
            o.append(v)
    return Recursion(*(torch.stack(o, dim=1) if o else
                       signal.new_zeros((B, 0), dtype=dt)
                       for o, dt in zip(outs, (torch.float32, torch.long,
                                               torch.long, torch.float32))))


@lru_cache(maxsize=64)
def _check_shapes(signal, lpc, inject):
    """Raises on shapes the kernel does not take (cached per shape set)."""
    if len(signal) != 2 or signal[1] % FRAME:
        raise ValueError(f"lpc_recursion: signal must be [B, T*{FRAME}], got "
                         f"{list(signal)}")
    B, S = signal
    if tuple(lpc) != (B, S // FRAME, ORDER):
        raise ValueError(f"lpc_recursion: lpc must be "
                         f"{[B, S // FRAME, ORDER]}, got {list(lpc)}")
    if inject is not None and tuple(inject) != (B, S):
        raise ValueError(f"lpc_recursion: the injected indices must be "
                         f"{[B, S]}, got {list(inject)}")


def lpc_recursion(signal: torch.Tensor, lpc: torch.Tensor,
                  inject: Optional[torch.Tensor] = None,
                  feedback: bool = False, drift_bound: int = 24
                  ) -> Recursion:
    """The teacher-forced recursion over B streams of T frames.

    signal [B, T*160] f32 (pre-emphasized), lpc [B, T, 16] f32 (the frame's
    taps), inject [B, T*160] int64 or None (no injection): added jitter, or
    with ``feedback`` the fed-back excitation clamped to ``drift_bound``
    levels around the target.  Returns ``Recursion`` (pred, exc_tgt, exc_fb,
    sig_rec), each [B, T*160]."""
    _check_shapes(tuple(signal.shape), tuple(lpc.shape),
                  None if inject is None else tuple(inject.shape))
    if signal.dtype != torch.float32 or lpc.dtype != torch.float32 or (
            inject is not None and inject.dtype != torch.long):
        raise TypeError("lpc_recursion: needs float32 signal and lpc, int64 "
                        "injected indices")
    tensors = (signal, lpc) + ((inject,) if inject is not None else ())
    if any(t.requires_grad for t in tensors):
        raise ValueError("lpc_recursion: forward only; its inputs must not "
                         "require grad")
    if any(t.device != signal.device for t in tensors):
        raise ValueError("lpc_recursion: tensors on more than one device")
    if signal.device.type == "cpu":
        return lpc_recursion_plain(signal, lpc, inject, feedback, drift_bound)
    if signal.device.type != "cuda":
        raise TypeError(f"lpc_recursion: needs a CUDA or CPU tensor, got "
                        f"{signal.device}")
    B, S = signal.shape
    signal, lpc = signal.contiguous(), lpc.contiguous()
    if inject is not None:
        inject = inject.contiguous()
    out = Recursion(torch.empty_like(signal),
                    torch.empty((B, S), dtype=torch.long, device=signal.device),
                    torch.empty((B, S), dtype=torch.long, device=signal.device),
                    torch.empty_like(signal))
    rc = _cuda.library().dss_lpc_recursion(
        signal.data_ptr(), lpc.data_ptr(),
        inject.data_ptr() if inject is not None else None,
        decode_table(signal.device).data_ptr(),
        out.pred.data_ptr(), out.exc_tgt.data_ptr(), out.exc_fb.data_ptr(),
        out.sig_rec.data_ptr(), B, S // FRAME, int(feedback),
        int(drift_bound), INV_LOG1P_MU, _cuda.stream_ptr(signal))
    _cuda.check(rc, "lpc_recursion")
    lpc_recursion.launches += 1
    return out


lpc_recursion.launches = 0
