"""Plain reference of the LPCNet feature math both vocoders share (Valin &
Skoglund, ICASSP 2019, arXiv:1810.11846): 18 Bark-like band cepstra ->
band energies -> interpolated power spectrum -> autocorrelation (lag
windowed) -> Levinson-Durbin -> 16 LPC taps; mu-law companding; the pitch
features.  Plain PyTorch in the caller's dtype."""

from __future__ import annotations

import numpy as np
import torch

FRAME = 160
WINDOW = 320
FREQ = WINDOW // 2 + 1
BANDS = 18
ORDER = 16
RATE = 16000
PREEMPH = 0.85
PITCH_MIN, PITCH_MAX = 32, 256
CENTERS = np.array([0, 200, 400, 600, 800, 1000, 1200, 1400, 1600, 2000,
                    2400, 2800, 3200, 4000, 4800, 5600, 6800, 8000], float)


def band_matrix() -> np.ndarray:
    """[18, 161] triangular weights; each bin's weights sum to one."""
    bin_hz = RATE / 2.0 / (FREQ - 1)
    f = np.arange(FREQ) * bin_hz
    W = np.zeros((BANDS, FREQ))
    c = CENTERS
    for b in range(BANDS):
        lo = c[b - 1] if b > 0 else c[0]
        hi = c[b + 1] if b < BANDS - 1 else c[-1]
        tri = np.minimum(np.clip((f - lo) / max(c[b] - lo, bin_hz), 0, 1),
                         np.clip((hi - f) / max(hi - c[b], bin_hz), 0, 1))
        if b == 0:
            tri[f <= c[0]] = 1.0
            tri[f > c[1]] = 0.0
            sel = (f > c[0]) & (f <= c[1])
            tri[sel] = ((c[1] - f) / (c[1] - c[0]))[sel]
        if b == BANDS - 1:
            tri[f >= c[b]] = 1.0
            sel = (f < c[b]) & (f >= c[-2])
            tri[sel] = ((f - c[-2]) / (c[b] - c[-2]))[sel]
        W[b] = tri
    col = W.sum(axis=0)
    col[col == 0] = 1.0
    return W / col


def dct_matrix(n: int = BANDS) -> np.ndarray:
    k, i = np.arange(n)[:, None], np.arange(n)[None, :]
    M = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    M[0] /= np.sqrt(2.0)
    return M


LAG_WINDOW = np.exp(-0.5 * (2 * np.pi * 60.0 * np.arange(ORDER + 1)
                            / RATE) ** 2)
_BANDS, _DCT = band_matrix(), dct_matrix()


def _c(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def levinson(r: torch.Tensor):
    """Autocorrelation [.., 17] -> (a [.., 16], residual energy [..]), with
    pred[n] = -sum_k a[k] x[n - 1 - k]."""
    a = torch.zeros(r.shape[:-1] + (ORDER,), dtype=r.dtype, device=r.device)
    err = r[..., 0] + 1e-9
    for i in range(ORDER):
        acc = r[..., i + 1] + (a[..., :i] * r[..., 1:i + 1].flip(-1)).sum(-1)
        k = -acc / err
        new = a.clone()
        new[..., :i] = a[..., :i] + k[..., None] * a[..., :i].flip(-1)
        new[..., i] = k
        a = new
        err = err * (1.0 - k * k)
    return a, err


def lpc_from_cepstrum(cep: torch.Tensor):
    """Cepstrum [.., 18] -> (lpc [.., 16], residual energy [..])."""
    bands = torch.pow(10.0, cep @ _c(_DCT, cep))
    psd = bands @ _c(_BANDS, bands)
    # bfloat16 has no FFT: below float64 the transform runs in float32.
    wide = psd if psd.dtype == torch.float64 else psd.to(torch.float32)
    r = torch.fft.irfft(wide, n=WINDOW)[..., :ORDER + 1]
    r = r.to(cep.dtype) * _c(LAG_WINDOW, cep)
    return levinson(r)


def pitch(f18: torch.Tensor, f19: torch.Tensor):
    """(period in [32, 256], rounded half to even; correlation in [0, 1])."""
    period = torch.clamp(torch.round(f18 * 50.0 + 100.0), PITCH_MIN,
                         PITCH_MAX)
    return period, torch.clamp(f19 + 0.5, 0.0, 1.0)


_y = np.arange(256) / 255.0 * 2.0 - 1.0
# Each level the float32 nearest its exact value, as the vocoder's samples
# hold them.
MULAW_LEVELS = (np.sign(_y) * (np.power(256.0, np.abs(_y)) - 1.0) / 255.0
                ).astype(np.float32)


def mulaw_encode(x: torch.Tensor) -> torch.Tensor:
    """Signal in [-1, 1] -> level index 0..255."""
    x = x.clamp(-1.0, 1.0)
    y = torch.sign(x) * torch.log1p(255.0 * x.abs()) / np.log1p(255.0)
    return torch.round((y + 1.0) * 127.5).clamp(0, 255).long()


_M32 = 0xFFFFFFFF


def _mul32(h, c):
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)
