"""IIR filtering for the high-gamma front end (counterpart of
dss_tpu/ops/filters.py).

Filters are designed once on the host with scipy as second-order sections;
``sosfilt_scan`` runs the cascade in torch with scipy's state layout
``zi [n_sections, 2, channels]``, so chunked filtering equals one pass.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import signal as _sig


def design_bandpass(fs: float, l_freq: float, h_freq: float,
                    order: int = 8) -> np.ndarray:
    """Butterworth band-pass as second-order sections (float64 design)."""
    return _sig.butter(order, [l_freq, h_freq], btype="bandpass", fs=fs,
                       output="sos")


def design_bandstop(fs: float, l_freq: float, h_freq: float,
                    order: int = 8) -> np.ndarray:
    """Butterworth band-stop as second-order sections (float64 design)."""
    return _sig.butter(order, [l_freq, h_freq], btype="bandstop", fs=fs,
                       output="sos")


def sosfilt_zi(sos: np.ndarray, nb_channels: int) -> np.ndarray:
    """scipy's steady-state ``sosfilt_zi`` tiled per channel:
    [n_sections, 2, nb_channels]."""
    zi = _sig.sosfilt_zi(sos)
    return np.repeat(zi[:, :, None], nb_channels, axis=-1)


def sosfilt_scan(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor):
    """Cascade of transposed direct-form II sections over x [T, C] with
    state zi [S, 2, C].  Returns (y [T, C], zf [S, 2, C]).

    Each section computes, per sample, exactly the reference's
    ``y = b0 x + z0;  z0 = b1 x - a1 y + z1;  z1 = b2 x - a2 y``.  The
    sections run as a wavefront: at step k, section s handles sample
    k - s, whose input is section s-1's output from step k-1.  All active
    sections advance in one set of [S, C] tensor ops, so a packet costs
    T + S - 1 steps instead of T * S, with the same arithmetic per element.
    """
    sos = torch.as_tensor(sos, dtype=x.dtype, device=x.device)
    S = sos.shape[0]
    T = x.shape[0]
    b0, b1, b2 = sos[:, 0:1], sos[:, 1:2], sos[:, 2:3]
    a1, a2 = sos[:, 4:5], sos[:, 5:6]
    z0 = zi[:, 0].to(x.dtype).clone()
    z1 = zi[:, 1].to(x.dtype).clone()
    y_prev = torch.zeros_like(z0)
    ys = []
    for k in range(T + S - 1):
        lo, hi = max(0, k - T + 1), min(S, k + 1)
        if lo == 0:
            xin = torch.cat([x[k:k + 1], y_prev[:hi - 1]], dim=0)
        else:
            xin = y_prev[lo - 1:hi - 1]
        y = b0[lo:hi] * xin + z0[lo:hi]
        z0[lo:hi] = b1[lo:hi] * xin - a1[lo:hi] * y + z1[lo:hi]
        z1[lo:hi] = b2[lo:hi] * xin - a2[lo:hi] * y
        y_prev[lo:hi] = y
        if hi == S:
            ys.append(y[-1])
    return torch.stack(ys), torch.stack([z0, z1], dim=1)
