"""Cepstrum -> band energies -> LPC (counterpart of dss_tpu/vocoder/lpc.py).

The band and DCT matrices are built in numpy on the host, exactly as the
reference defines them; the math runs batched in torch over any leading
dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant

FRAME_SIZE = 160          # 10 ms @ 16 kHz
WINDOW_SIZE = 320         # 20 ms analysis window (2 frames)
FREQ_SIZE = WINDOW_SIZE // 2 + 1
NB_BANDS = 18
NB_FEATURES = 20
LPC_ORDER = 16
SAMPLE_RATE = 16000
PREEMPH = 0.85

BAND_CENTERS_HZ = np.array(
    [0, 200, 400, 600, 800, 1000, 1200, 1400, 1600, 2000, 2400, 2800,
     3200, 4000, 4800, 5600, 6800, 8000], dtype=np.float64
)


def _band_matrix() -> np.ndarray:
    """[NB_BANDS, FREQ_SIZE] triangular interpolation weights; every FFT
    bin's weights sum to 1 across bands."""
    bin_hz = SAMPLE_RATE / 2.0 / (FREQ_SIZE - 1)
    freqs = np.arange(FREQ_SIZE) * bin_hz
    W = np.zeros((NB_BANDS, FREQ_SIZE))
    centers = BAND_CENTERS_HZ
    for b in range(NB_BANDS):
        lo = centers[b - 1] if b > 0 else centers[0]
        mid = centers[b]
        hi = centers[b + 1] if b < NB_BANDS - 1 else centers[-1]
        up = (freqs - lo) / max(mid - lo, bin_hz)
        down = (hi - freqs) / max(hi - mid, bin_hz)
        tri = np.minimum(np.clip(up, 0, 1), np.clip(down, 0, 1))
        if b == 0:
            tri[freqs <= mid] = 1.0
            tri[freqs > centers[1]] = 0.0
            down = (centers[1] - freqs) / (centers[1] - mid)
            sel = (freqs > mid) & (freqs <= centers[1])
            tri[sel] = down[sel]
        if b == NB_BANDS - 1:
            tri[freqs >= mid] = 1.0
            up = (freqs - centers[-2]) / (mid - centers[-2])
            sel = (freqs < mid) & (freqs >= centers[-2])
            tri[sel] = up[sel]
        W[b] = tri
    col = W.sum(axis=0)
    col[col == 0] = 1.0
    return W / col


def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis (scipy.fftpack.dct norm='ortho')."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    M = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    M[0] *= 1.0 / np.sqrt(2.0)
    return M


BAND_MATRIX = _band_matrix()
DCT_MATRIX = _dct_matrix(NB_BANDS)
# Gaussian lag window applied to the autocorrelation before Levinson.
LAG_WINDOW = np.exp(
    -0.5 * (2.0 * np.pi * 60.0 * np.arange(LPC_ORDER + 1) / SAMPLE_RATE) ** 2
)


def _const(name: str, like: torch.Tensor) -> torch.Tensor:
    return device_constant(name, like.device, like.dtype,
                           lambda: globals()[name])


def bands_from_cepstrum(cepstrum: torch.Tensor) -> torch.Tensor:
    """[.., NB_BANDS] cepstrum -> band energies."""
    logE = cepstrum @ _const("DCT_MATRIX", cepstrum)
    return torch.pow(10.0, logE)


def levinson(r: torch.Tensor, order: int = LPC_ORDER):
    """Levinson-Durbin over the last axis: autocorrelation [.., order+1] ->
    (lpc a[.., order], residual energy [..]).  Convention:
    pred[n] = -sum_k a[k] x[n-k]."""
    a = torch.zeros(r.shape[:-1] + (order,), dtype=r.dtype, device=r.device)
    err = r[..., 0] + 1e-9
    for i in range(order):
        acc = r[..., i + 1]
        for j in range(i):
            acc = acc + a[..., j] * r[..., i - j]
        k = -acc / err
        if i > 0:
            a = torch.cat([a[..., :i] + k[..., None] * a[..., :i].flip(-1),
                           a[..., i:]], dim=-1)
        a = torch.cat([a[..., :i], k[..., None], a[..., i + 1:]], dim=-1)
        err = err * (1.0 - k * k)
    return a, err


def lpc_from_bands(bands: torch.Tensor):
    """Band energies [.., NB_BANDS] -> (lpc [.., LPC_ORDER], residual)."""
    psd = bands @ _const("BAND_MATRIX", bands)
    r = torch.fft.irfft(psd, n=WINDOW_SIZE)[..., : LPC_ORDER + 1]
    return levinson(r * _const("LAG_WINDOW", r))
