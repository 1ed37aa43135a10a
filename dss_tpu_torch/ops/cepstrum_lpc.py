"""The neural vocoder's LPC (kernel D4, csrc/cepstrum_lpc.cu) and its plain
PyTorch version.

Cepstrum -> 16 LPC taps for every frame of a synthesis block of B streams
x L frames: the 18 cepstra through the DCT to 18 band energies, the bands
to a 161-bin PSD, its inverse real FFT at lags 0..16, the lag window, and
Levinson-Durbin; the JAX package computes the same per frame
(dss_tpu/vocoder/lpc.py, ``lpc_from_cepstrum``).  The kernel runs one warp
a frame in one launch; its arithmetic is csrc/cepstrum_lpc.cuh, which D1's
prologue shares.  It equals the plain version,
vocoder/lpc.py::lpc_from_cepstrum_framewise, bit for bit on the card (the
same float operations in the same order, torch's powf the same library
call), and that equals ``lpc_from_cepstrum`` up to float32 rounding
(~1e-7 on the benchmark's features; Levinson amplifies it to ~1e-2 on
strongly resonant speech frames, where the two float32 routes are about
equally far from float64).  Each frame's taps depend on that frame alone,
so a block split into calls, or a batch split into shards, gives the same
taps.

``lpc_frames`` takes the cepstrum [B, L, C >= 18] through its strides (the
vocoder's features [B, L, 20] as they are: the first 18 columns are read)
and returns the taps in the sampler's layout, [L, B, 16] float32
contiguous.  CUDA tensors launch the kernel (or raise); CPU tensors take
the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant
from . import _cuda

BANDS = 18   # cepstra a frame (kBands in the source)
ORDER = 16   # LPC taps (kOrder in the source)


def tables(device) -> torch.Tensor:
    """The kernels' constant tables in one float32 buffer on ``device``, in
    csrc/cepstrum_lpc.cuh's layout: the inverse-FFT lags transposed and
    zero-padded to [17, 256], DCT_MATRIX_32 [18, 32], BAND_MATRIX
    [18, 161], LAG_WINDOW [17]; each rounded to float32 as
    vocoder/lpc.py's device constants.  D1 reads the same buffer."""
    from ..vocoder import lpc

    def make():
        lags = np.zeros((ORDER + 1, 256), np.float32)
        lags[:, :lpc.FREQ_SIZE] = np.float32(lpc.IRFFT_LAGS).T
        return np.concatenate([lags.ravel(),
                               np.float32(lpc.DCT_MATRIX_32).ravel(),
                               np.float32(lpc.BAND_MATRIX).ravel(),
                               np.float32(lpc.LAG_WINDOW)])
    return device_constant("cepstrum_lpc_tables", device, torch.float32,
                           make)


def lpc_frames_plain(cepstrum: torch.Tensor) -> torch.Tensor:
    """Plain version of ``lpc_frames``:
    ``lpc_from_cepstrum_framewise`` on the first 18 columns, transposed to
    [L, B, 16]."""
    from ..vocoder.lpc import lpc_from_cepstrum_framewise
    lpc, _ = lpc_from_cepstrum_framewise(cepstrum[..., :BANDS])
    return lpc.transpose(0, 1).contiguous()


def lpc_frames(cepstrum: torch.Tensor) -> torch.Tensor:
    """cepstrum [B, L, C >= 18] float32, any strides -> LPC taps [L, B, 16]
    float32 contiguous, one launch on a CUDA tensor (counted in
    ``lpc_frames.launches``); a CPU tensor takes ``lpc_frames_plain``."""
    if cepstrum.dim() != 3 or cepstrum.shape[-1] < BANDS \
            or cepstrum.dtype != torch.float32:
        raise ValueError(f"lpc_frames: needs float32 [B, L, >= {BANDS}], "
                         f"got {cepstrum.dtype} {list(cepstrum.shape)}")
    if cepstrum.device.type == "cpu":
        return lpc_frames_plain(cepstrum)
    if cepstrum.device.type != "cuda":
        raise TypeError(f"lpc_frames: needs a CUDA or CPU tensor, got "
                        f"{cepstrum.device}")
    B, L = cepstrum.shape[:2]
    dev = cepstrum.device
    out = torch.empty((L, B, ORDER), dtype=torch.float32, device=dev)
    if B * L == 0:
        return out
    rc = _cuda.library().dss_cepstrum_lpc(
        cepstrum.data_ptr(), *cepstrum.stride(), tables(dev).data_ptr(),
        out.data_ptr(), B, L, _cuda.stream_ptr(cepstrum))
    _cuda.check(rc, "cepstrum_lpc")
    lpc_frames.launches += 1
    return out


lpc_frames.launches = 0
