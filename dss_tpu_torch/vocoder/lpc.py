"""Band energies, cepstra and LPC (counterpart of dss_tpu/vocoder/lpc.py):
spectrum -> bands -> cepstrum for the feature encoder, cepstrum -> bands ->
PSD -> autocorrelation -> LPC for the vocoders.

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


def band_energies(spectrum_sq: torch.Tensor) -> torch.Tensor:
    """|X(f)|^2 [.., FREQ_SIZE] -> band energies [.., NB_BANDS]."""
    return spectrum_sq @ _const("BAND_MATRIX", spectrum_sq).T


def psd_from_bands(bands: torch.Tensor) -> torch.Tensor:
    """Band energies -> interpolated linear-frequency PSD [.., FREQ_SIZE]."""
    return bands @ _const("BAND_MATRIX", bands)


def cepstrum_from_bands(bands: torch.Tensor, floor: float = 1e-9
                        ) -> torch.Tensor:
    """Band energies [.., NB_BANDS] -> cepstrum (DCT of log10 energies)."""
    return torch.log10(bands + floor) @ _const("DCT_MATRIX", bands).T


def bands_from_cepstrum(cepstrum: torch.Tensor) -> torch.Tensor:
    """[.., NB_BANDS] cepstrum -> band energies."""
    logE = cepstrum @ _const("DCT_MATRIX", cepstrum)
    return torch.pow(10.0, logE)


def autocorr_from_psd(psd: torch.Tensor, order: int = LPC_ORDER
                      ) -> torch.Tensor:
    """PSD [.., FREQ_SIZE] -> lag-windowed autocorrelation r[.., 0..order]
    (inverse real FFT)."""
    r = torch.fft.irfft(psd, n=WINDOW_SIZE)[..., : order + 1]
    return r * _const("LAG_WINDOW", r)[: order + 1]


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
    return levinson(autocorr_from_psd(psd_from_bands(bands)))


def lpc_from_cepstrum(cepstrum: torch.Tensor):
    """Cepstrum [.., NB_BANDS] -> (lpc [.., LPC_ORDER], residual)."""
    return lpc_from_bands(bands_from_cepstrum(cepstrum))


def _irfft_lags() -> np.ndarray:
    """[FREQ_SIZE, LPC_ORDER + 1]: lags 0..LPC_ORDER of the inverse real
    FFT of length WINDOW_SIZE as a product, r = psd @ C."""
    f = np.arange(FREQ_SIZE)[:, None]
    k = np.arange(LPC_ORDER + 1)[None, :]
    weight = np.where((f == 0) | (f == FREQ_SIZE - 1), 1.0, 2.0)
    return weight * np.cos(2.0 * np.pi * f * k / WINDOW_SIZE) / WINDOW_SIZE


IRFFT_LAGS = _irfft_lags()
# The DCT's inverse with 14 zero columns: 32 log energies a frame.
DCT_MATRIX_32 = np.pad(DCT_MATRIX, ((0, 0), (0, 32 - NB_BANDS)))


def _rowwise_matmul(x: torch.Tensor, name: str) -> torch.Tensor:
    """x [.., K] @ the constant ``name`` [K, N], every output summed over K
    as a fixed pairwise tree of elementwise adds: a row's result does not
    depend on how many rows share the call (a library product or FFT may
    pick another summation order for another batch size)."""
    prod = x[..., :, None] * _const(name, x)               # [.., K, N]
    K = prod.shape[-2]
    pad = (1 << (K - 1).bit_length()) - K
    if pad:
        prod = torch.cat([prod, prod.new_zeros(
            prod.shape[:-2] + (pad, prod.shape[-1]))], dim=-2)
    while prod.shape[-2] > 1:
        prod = prod[..., 0::2, :] + prod[..., 1::2, :]
    return prod[..., 0, :]


def lpc_from_cepstrum_framewise(cepstrum: torch.Tensor):
    """``lpc_from_cepstrum`` with each frame's arithmetic independent of the
    other frames of the call, so that the DSP vocoder's chunked calls equal
    one call bit for bit: products as ``_rowwise_matmul``, the inverse FFT
    as a product for the 17 lags it needs, Levinson elementwise, and the
    power of ten over 32 values a frame (a vectorized CPU loop then leaves
    no frame's values to its scalar tail, which rounds ``pow`` otherwise).
    Equal to ``lpc_from_cepstrum`` up to f32 rounding."""
    bands = torch.pow(10.0, _rowwise_matmul(cepstrum, "DCT_MATRIX_32")
                      )[..., :NB_BANDS]
    psd = _rowwise_matmul(bands, "BAND_MATRIX")
    r = _rowwise_matmul(psd, "IRFFT_LAGS")
    return levinson(r * _const("LAG_WINDOW", r))
