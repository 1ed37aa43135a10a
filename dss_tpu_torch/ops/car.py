"""Re-referencing and normalization transforms on torch tensors shaped
[..., time, channels] (counterpart of dss_tpu/ops/car.py)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


class CommonAverageReferencing:
    """Subtract each grid's per-timepoint mean from that grid's channels.
    Channels in ``exclude_channels`` do not contribute to the mean but are
    still re-referenced."""

    def __init__(self, exclude_channels: Sequence[int], grids: List[np.ndarray],
                 layout: np.ndarray):
        self.grids = grids
        self.layout = np.asarray(layout)
        self.apply_idx: List[np.ndarray] = []
        self.compute_idx: List[np.ndarray] = []
        for grid in grids:
            in_grid = np.isin(self.layout, grid)
            excluded = np.isin(self.layout,
                               [c for c in exclude_channels if c in grid])
            self.apply_idx.append(np.flatnonzero(in_grid))
            self.compute_idx.append(np.flatnonzero(in_grid & ~excluded))
        self._device = None
        self._index: List = []

    def to(self, device) -> "CommonAverageReferencing":
        self._device = torch.device(device)
        self._index = [
            (torch.as_tensor(a, device=device), torch.as_tensor(c, device=device))
            for a, c in zip(self.apply_idx, self.compute_idx)]
        return self

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        if self._device != data.device:
            self.to(data.device)
        result = data.clone()
        for apply_idx, compute_idx in self._index:
            mean = data.index_select(-1, compute_idx).mean(-1, keepdim=True)
            result[..., apply_idx] -= mean
        return result


class ZScoreNormalization:
    """(x - mean) / std per channel with precomputed statistics."""

    def __init__(self, channel_means, channel_stds):
        self.channel_means = np.asarray(channel_means, np.float32)
        self.channel_stds = np.asarray(channel_stds, np.float32)
        self._stats = None

    def to(self, device) -> "ZScoreNormalization":
        self._stats = (torch.as_tensor(self.channel_means, device=device),
                       torch.as_tensor(self.channel_stds, device=device))
        return self

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        if self._stats is None or self._stats[0].device != data.device:
            self.to(data.device)
        mean, std = self._stats
        return (data - mean) / std
