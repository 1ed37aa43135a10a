"""Plain reference of the packet front end: channel order, common average
referencing, speech-area selection, the 70-170 Hz band-pass and 118-122 Hz
band-stop Butterworth cascade, warm-start framing (50 ms windows at a
10 ms hop) and log(mean(x^2) + 0.01), then z-scoring.

Written from the reference study's front end (Angrick et al., Sci Rep
14:9617, 2024) in float64 NumPy/SciPy; the channel tables are frozen copies
of the subject's electrode maps.  ``precision="bf16"`` is the control: the
filter's coefficients, its input and the features rounded to bfloat16.
"""

from __future__ import annotations

import numpy as np
from scipy import signal

from .rounding import round_bf16

FS = 1000
HOP, LENGTH = 10, 50          # samples: 10 ms hop, 50 ms window
EPS = 0.01
WARMUP = 3                    # windows before the first emitted one
BAD_CHANNELS = (19, 38, 48, 52)

# Raw amplifier channel -> grid-ordered channel (0-based), 128 of the 129.
BOTH_GRIDS_ORDER = np.array([
    125, 123, 121, 119, 122, 111, 118, 124, 120, 126, 127, 116, 114, 113,
    115, 117, 98, 97, 96, 104, 100, 102, 101, 99, 105, 112, 107, 106, 108,
    103, 109, 110, 17, 21, 9, 28, 26, 31, 13, 27, 25, 22, 30, 11, 29, 23,
    19, 15, 1, 2, 4, 0, 24, 12, 14, 7, 5, 18, 6, 10, 3, 8, 20, 16, 50, 33,
    44, 51, 63, 40, 38, 46, 42, 48, 56, 37, 35, 41, 47, 58, 61, 60, 59, 43,
    49, 45, 54, 62, 32, 53, 55, 52, 57, 39, 34, 36, 85, 84, 83, 87, 80, 86,
    90, 78, 75, 92, 76, 88, 82, 94, 70, 74, 69, 66, 79, 71, 73, 77, 68, 67,
    64, 65, 95, 93, 81, 72, 91, 89,
])

# The 68-entry speech-area map (0-based before the + 1); the bad channels
# leave 64 decoded channels, sorted.
_SPEECH_AREA_RAW = np.array([
    1, 2, 3, 0, 4, 11, 5, 6, 7, 10, 12, 9, 19, 8, 15, 20, 13, 14, 17, 22,
    18, 21, 29, 16, 23, 28, 35, 36, 27, 25, 26, 55, 45, 46, 44, 24, 37, 40,
    33, 34, 32, 51, 47, 39, 31, 54, 53, 30, 48, 38, 43, 41, 52, 61, 59, 62,
    49, 66, 60, 63, 58, 50, 42, 56, 67, 57, 81, 68,
]) + 1
SPEECH_AREA = np.sort(np.array(
    [c for c in _SPEECH_AREA_RAW if c not in BAD_CHANNELS]) - 1)


def _grids():
    speech = np.flip(np.arange(64).reshape(8, 8) + 1, axis=0)
    motor = np.flip(np.arange(64).reshape(8, 8) + 65, axis=0)
    return speech, motor


def car(x: np.ndarray) -> np.ndarray:
    """Subtract each grid's mean over its good channels from all of the
    grid's channels (columns are channels 1..128)."""
    layout = np.arange(128) + 1
    out = x.copy()
    for grid in _grids():
        in_grid = np.isin(layout, grid)
        good = in_grid & ~np.isin(layout, [c for c in BAD_CHANNELS
                                           if c in grid])
        out[:, in_grid] -= x[:, good].mean(axis=1, keepdims=True)
    return out


def cascade():
    """(sos [16, 6], zi [16, 2]): band-pass then band-stop, each order 8,
    each section state at its own filter's unit-step steady state."""
    bp = signal.butter(8, [70, 170], btype="bandpass", fs=FS, output="sos")
    bs = signal.butter(8, [118, 122], btype="bandstop", fs=FS, output="sos")
    return (np.concatenate([bp, bs]),
            np.concatenate([signal.sosfilt_zi(bp), signal.sosfilt_zi(bs)]))


def features(raw: np.ndarray, means=None, stds=None,
             precision: str = "float64") -> np.ndarray:
    """raw [N, 129] (N a multiple of 40) -> features [N // 10, 64]: the
    log power of every window of the stream after 40 zero samples, as the
    online front end computes it.  The first ``WARMUP`` windows reach the
    nVAD's state but are not emitted."""
    rnd = round_bf16 if precision == "bf16" else (lambda a: a)
    x = np.asarray(raw, np.float64)[:, BOTH_GRIDS_ORDER]
    x = car(x)[:, SPEECH_AREA]
    sos, zi = cascade()
    y, _ = signal.sosfilt(rnd(sos), rnd(x), axis=0,
                          zi=np.repeat(zi[:, :, None], x.shape[1], axis=2))
    y = np.concatenate([np.zeros((LENGTH - HOP, y.shape[1])), rnd(y)])
    sq = np.cumsum(np.concatenate([np.zeros((1, y.shape[1])), y * y]), 0)
    starts = np.arange((len(y) - LENGTH) // HOP + 1) * HOP
    power = (sq[starts + LENGTH] - sq[starts]) / LENGTH
    f = np.log(power + EPS)
    if means is not None:
        f = (f - means) / stds
    return rnd(f)
