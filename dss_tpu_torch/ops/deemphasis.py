"""The neural vocoder's de-emphasis (kernel D5, csrc/deemphasis.cu), its
host loop (csrc/deemphasis_host.cpp) and its plain version.

y[t] = s[t] + PREEMPH * y[t-1] over each stream of a synthesis block, from
the carried y[-1]: one float32 multiply and one add a sample, each rounded
once, in that order.  The kernel (CUDA tensors), the host loop (CPU
tensors) and ``deemphasis_plain`` (numpy, the reference) equal one another
bit for bit, and a sample depends on its stream's past alone: a stream
split into calls at any sample, or a batch split into shards, gives the
same bits as one call.  The JAX package computes the same recurrence in a
blocked form (dss_tpu/vocoder/net.py); the two agree up to float32
rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..vocoder.lpc import PREEMPH
from . import _cuda, _host


def deemphasis_plain(sig: np.ndarray, y0: np.ndarray) -> np.ndarray:
    """Plain version: sig [B, N] and y0 [B] float32 -> y [B, N] float32,
    the recurrence sample by sample in numpy."""
    a = np.float32(PREEMPH)
    s = np.ascontiguousarray(np.asarray(sig, np.float32).T)
    y = np.empty_like(s)
    prev = np.asarray(y0, np.float32).copy()
    for t in range(s.shape[0]):
        prev = s[t] + a * prev
        y[t] = prev
    return y.T.copy()


def _check(sig, y0, out):
    if sig.dim() != 2 or sig.dtype != torch.float32 or sig.stride(1) != 1:
        raise ValueError(f"deemphasis: needs float32 [B, N] rows of unit "
                         f"stride, got {sig.dtype} {list(sig.shape)} "
                         f"strides {sig.stride()}")
    if tuple(y0.shape) != sig.shape[:1] or y0.dtype != torch.float32:
        raise ValueError(f"deemphasis: y0 must be float32 [{sig.shape[0]}], "
                         f"got {y0.dtype} {list(y0.shape)}")
    if out.shape != sig.shape or out.dtype != torch.float32 \
            or out.stride(1) != 1:
        raise ValueError(f"deemphasis: out must be float32 {list(sig.shape)} "
                         f"with rows of unit stride, got {out.dtype} "
                         f"{list(out.shape)} strides {out.stride()}")
    if not sig.device == y0.device == out.device:
        raise ValueError("deemphasis: sig, y0 and out must share a device")


def deemphasis(sig: torch.Tensor, y0: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
    """Writes y [B, N] of sig [B, N] from y0 [B] into ``out`` (same shape;
    rows of unit stride, any row stride: a column slice of the call's
    buffer) and returns y[:, -1] [B], the carry of the next call.  One
    launch on CUDA tensors (counted in ``deemphasis.launches``), the host
    loop on CPU tensors."""
    _check(sig, y0, out)
    B, N = sig.shape
    last = torch.empty_like(y0)
    if N == 0:
        return last.copy_(y0)
    y0 = y0.contiguous()
    if sig.device.type == "cpu":
        rc = _host.library().dss_deemphasis_host(
            sig.data_ptr(), sig.stride(0), y0.data_ptr(), out.data_ptr(),
            out.stride(0), last.data_ptr(), B, N, PREEMPH)
        if rc != 0:
            raise RuntimeError(f"dss_deemphasis_host returned {rc}")
        return last
    if sig.device.type != "cuda":
        raise TypeError(f"deemphasis: needs a CUDA or CPU tensor, got "
                        f"{sig.device}")
    if B == 0:
        return last
    rc = _cuda.library().dss_deemphasis(
        sig.data_ptr(), sig.stride(0), y0.data_ptr(), out.data_ptr(),
        out.stride(0), last.data_ptr(), B, N, PREEMPH,
        _cuda.stream_ptr(sig))
    _cuda.check(rc, "deemphasis")
    deemphasis.launches += 1
    return last


deemphasis.launches = 0
