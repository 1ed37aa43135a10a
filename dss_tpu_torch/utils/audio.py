"""Audio helpers: peak normalization and wav I/O (the port's own copy of
dss_tpu/utils/audio.py).

``peak_normalize`` is the corpus preparation's gain: peak to full scale
minus a headroom, then ``gain_db``, with round-half-away rounding and
int16 saturation.
"""

from __future__ import annotations

import numpy as np
from scipy.io.wavfile import read as _wavread
from scipy.io.wavfile import write as _wavwrite

MAX_POSSIBLE_AMPLITUDE = 32768.0  # 16-bit full scale


def peak_normalize(audio: np.ndarray, headroom_db: float = 0.1,
                   gain_db: float = -3.0) -> np.ndarray:
    """Scale int16 audio so its peak reaches full scale minus headroom, then
    apply ``gain_db`` (default -3 dB)."""
    audio = np.asarray(audio)
    peak = float(np.max(np.abs(audio.astype(np.int64)))) if audio.size else 0.0
    if peak == 0.0:
        return audio.astype(np.int16)
    target_peak = MAX_POSSIBLE_AMPLITUDE * (10.0 ** (-headroom_db / 20.0))
    gain = (target_peak / peak) * (10.0 ** (gain_db / 20.0))
    scaled = np.round(audio.astype(np.float64) * gain)
    return np.clip(scaled, -32768, 32767).astype(np.int16)


def write_wav(filename: str, data: np.ndarray, fs: int = 16000) -> None:
    _wavwrite(filename, fs, data)


def read_wav(filename: str):
    fs, data = _wavread(filename)
    return fs, data
