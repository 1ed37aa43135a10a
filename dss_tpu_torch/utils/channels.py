"""Subject-specific electrode maps and channel-selection transforms (a copy
of dss_tpu/utils/channels.py, selecting on torch tensors as well).

The permutation tables are normative data constants of the recorded
subject (two 8x8 grids; 64 speech-informative electrodes) and must match
the reference bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# Raw amplifier channel -> grid-ordered channel permutation (0-based).
BOTH_GRIDS_ORDER: np.ndarray = np.array([
    125, 123, 121, 119, 122, 111, 118, 124, 120, 126, 127, 116, 114, 113,
    115, 117, 98, 97, 96, 104, 100, 102, 101, 99, 105, 112, 107, 106, 108,
    103, 109, 110, 17, 21, 9, 28, 26, 31, 13, 27, 25, 22, 30, 11, 29, 23,
    19, 15, 1, 2, 4, 0, 24, 12, 14, 7, 5, 18, 6, 10, 3, 8, 20, 16, 50, 33,
    44, 51, 63, 40, 38, 46, 42, 48, 56, 37, 35, 41, 47, 58, 61, 60, 59, 43,
    49, 45, 54, 62, 32, 53, 55, 52, 57, 39, 34, 36, 85, 84, 83, 87, 80, 86,
    90, 78, 75, 92, 76, 88, 82, 94, 70, 74, 69, 66, 79, 71, 73, 77, 68, 67,
    64, 65, 95, 93, 81, 72, 91, 89,
], dtype=np.int32)

# 68-entry speech-area electrode map (1-based) from which the four bad
# channels 19/38/48/52 are removed, then sorted — the 64 decoded channels.
_SPEECH_AREA_RAW = np.array([
    1, 2, 3, 0, 4, 11, 5, 6, 7, 10, 12, 9, 19, 8, 15, 20, 13, 14, 17, 22,
    18, 21, 29, 16, 23, 28, 35, 36, 27, 25, 26, 55, 45, 46, 44, 24, 37, 40,
    33, 34, 32, 51, 47, 39, 31, 54, 53, 30, 48, 38, 43, 41, 52, 61, 59, 62,
    49, 66, 60, 63, 58, 50, 42, 56, 67, 57, 81, 68,
], dtype=np.int32) + 1

_BAD_SPEECH_CHANNELS = (19, 38, 48, 52)

SPEECH_AREA_CHANNELS: np.ndarray = np.sort(
    np.array([c for c in _SPEECH_AREA_RAW if c not in _BAD_SPEECH_CHANNELS],
             dtype=np.int32) - 1
)


def speech_grid() -> np.ndarray:
    """8x8 speech grid numbering (1..64), row-flipped as mounted."""
    return np.flip(np.arange(64, dtype=np.int16).reshape((8, 8)) + 1, axis=0)


def motor_grid() -> np.ndarray:
    """8x8 motor grid numbering (65..128)."""
    return np.flip(np.arange(64, dtype=np.int16).reshape((8, 8)) + 65, axis=0)


def default_layout() -> np.ndarray:
    """Identity layout mapping data columns to channel numbers 1..128."""
    return np.arange(128, dtype=np.int32) + 1


class _IndexSelector:
    """Gather a fixed channel permutation/selection along the last axis of
    a numpy array or a torch tensor."""

    indices: np.ndarray
    _index = None  # torch copy of ``indices`` on the device set by ``to``

    def __len__(self) -> int:
        return len(self.indices)

    def to(self, device) -> "_IndexSelector":
        self._index = torch.as_tensor(self.indices, dtype=torch.long,
                                      device=device)
        return self

    def __call__(self, data):
        if not isinstance(data, torch.Tensor):
            return data[..., self.indices]
        idx = self._index
        if idx is None or idx.device != data.device:
            idx = torch.as_tensor(self.indices, dtype=torch.long,
                                  device=data.device)
        return data.index_select(-1, idx)


class SelectElectrodesFromBothGrids(_IndexSelector):
    """Reorder the 128 raw amplifier channels into grid order."""

    def __init__(self):
        self.indices = BOTH_GRIDS_ORDER


class SelectElectrodesOverSpeechAreas(_IndexSelector):
    """Select the 64 speech-informative electrodes (sorted order)."""

    def __init__(self):
        self.indices = SPEECH_AREA_CHANNELS

    def __repr__(self) -> str:
        return f"Channels: {', '.join(map(str, self.indices + 1))}"
