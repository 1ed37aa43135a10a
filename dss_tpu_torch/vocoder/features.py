"""Acoustic feature encoder: 16 kHz PCM -> 20-dim vocoder features
(counterpart of dss_tpu/vocoder/features.py).

The features are the JAX package's own self-consistent scaling of the
reference's LPCNet features: 18 Bark-scale cepstra, then

    features[18] = (pitch_period - 100) / 50        (period in samples)
    features[19] = pitch_correlation - 0.5          (in [-0.5, 0.5])

All frames of a buffer are encoded at once, batched over frames: windowed
``torch.fft.rfft`` for the bands, and the pitch search's lagged windows as
a strided view of each frame's context.  A carried pre-emphasis memory and
history make chunked streaming equal to one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant, resolve_device
from .lpc import FRAME_SIZE, NB_FEATURES, PREEMPH, WINDOW_SIZE, \
    band_energies, cepstrum_from_bands

PITCH_MIN = 32     # 500 Hz
PITCH_MAX = 256    # 62.5 Hz
_HISTORY = WINDOW_SIZE - FRAME_SIZE + PITCH_MAX  # look-back needed per frame


def pitch_feature_encode(period, corr):
    """(period in samples, correlation) -> (features[18], features[19])."""
    return (period - 100.0) / 50.0, corr - 0.5


def pitch_feature_decode(f18: torch.Tensor, f19: torch.Tensor):
    """(features[18], features[19]) -> (period in [PITCH_MIN, PITCH_MAX],
    rounded half to even; correlation in [0, 1])."""
    period = torch.clamp(torch.round(f18 * 50.0 + 100.0), PITCH_MIN,
                         PITCH_MAX)
    corr = torch.clamp(f19 + 0.5, 0.0, 1.0)
    return period, corr


def _frame_features(segments: torch.Tensor) -> torch.Tensor:
    """Features [N, 20] of N frames given their contexts
    [N, HISTORY + FRAME_SIZE].

    The analysis window is each context's trailing WINDOW_SIZE samples;
    the pitch search correlates it against its copies PITCH_MIN..PITCH_MAX
    samples back.  The correlation's argmax takes the lowest lag among
    equal maxima, as ``jnp.argmax`` does."""
    window = segments[:, -WINDOW_SIZE:]
    hann = device_constant("hann", segments.device, segments.dtype,
                           lambda: np.hanning(WINDOW_SIZE))
    spec = torch.fft.rfft(window * hann)
    bands = band_energies(spec.abs() ** 2 / WINDOW_SIZE)
    cepstrum = cepstrum_from_bands(bands)

    # lagged[:, i] is the window PITCH_MIN + i samples back: a view of the
    # context's windows at every start, in reverse order of start.
    base = segments.shape[1] - WINDOW_SIZE
    starts = segments.unfold(1, WINDOW_SIZE, 1)            # [N, base+1, W]
    lagged = starts[:, base - PITCH_MAX: base - PITCH_MIN + 1].flip(1)
    num = (lagged * window[:, None, :]).sum(-1)            # [N, L]
    e0 = (window * window).sum(-1)
    e_lag = (lagged * lagged).sum(-1)
    corr = num / torch.sqrt(e0[:, None] * e_lag + 1e-9)

    best = torch.argmax(corr, dim=1)
    best_corr = corr.gather(1, best[:, None])[:, 0]
    period = (PITCH_MIN + best).to(segments.dtype)

    # Octave-error check: prefer half the period when nearly as correlated.
    half_idx = torch.clamp((period / 2.0).to(torch.long) - PITCH_MIN, min=0)
    half_corr = corr.gather(1, half_idx[:, None])[:, 0]
    half_ok = (period / 2.0 >= PITCH_MIN) & (half_corr > 0.85 * best_corr)
    period = torch.where(half_ok, torch.round(period / 2.0), period)
    best_corr = torch.clamp(torch.where(half_ok, half_corr, best_corr),
                            0.0, 1.0)

    f18, f19 = pitch_feature_encode(period, best_corr)
    return torch.cat([cepstrum, f18[:, None], f19[:, None]], dim=1)


def _encode_buffer(history_and_audio: torch.Tensor, num_frames: int
                   ) -> torch.Tensor:
    """[HISTORY + num_frames*FRAME_SIZE] signal -> features [num_frames, 20]."""
    segments = history_and_audio.unfold(0, _HISTORY + FRAME_SIZE, FRAME_SIZE)
    return _frame_features(segments[:num_frames])


class LPCFeatureEncoder:
    """Stateful encoder with the reference's ``compute_LPC_features`` API.
    Runs on the card unless ``device`` says otherwise."""

    NB_FEATURES = NB_FEATURES
    LPCNET_FRAME_SIZE = FRAME_SIZE

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.reset_encoder()

    def reset_encoder(self) -> None:
        self._history = np.zeros(_HISTORY, dtype=np.float32)
        self._preemph_mem = 0.0

    @torch.no_grad()
    def compute_LPC_features(self, audio_samples: np.ndarray) -> np.ndarray:
        """int16 (or float in [-1, 1]) PCM -> float32 [N, 20] features.

        N = len(audio) // 160; a trailing partial frame is ignored, as the
        reference binding does."""
        audio = np.asarray(audio_samples)
        if np.issubdtype(audio.dtype, np.integer):
            audio = audio.astype(np.float32) / 32768.0
        else:
            audio = audio.astype(np.float32)
        num_frames = len(audio) // FRAME_SIZE
        if num_frames == 0:
            return np.zeros((0, NB_FEATURES), dtype=np.float32)
        audio = audio[: num_frames * FRAME_SIZE]

        # Pre-emphasis with carried filter memory (host, as the reference).
        shifted = np.concatenate([[self._preemph_mem], audio[:-1]])
        emphasized = audio - PREEMPH * shifted
        self._preemph_mem = audio[-1]

        buf = np.concatenate([self._history, emphasized]).astype(np.float32)
        feats = _encode_buffer(torch.as_tensor(buf, device=self.device),
                               num_frames)
        self._history = buf[-_HISTORY:]
        return feats.cpu().numpy()
