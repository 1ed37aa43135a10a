"""Re-referencing, bad-channel patching and normalization transforms on
torch tensors shaped [..., time, channels] (counterpart of
dss_tpu/ops/car.py).  Index sets are resolved on the host at construction;
``to(device)`` puts them on the device the transform is called on."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from scipy.ndimage import binary_dilation


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


class BadChannelCorrection:
    """Replace each bad channel with the mean of its non-bad 8-neighbourhood
    on its grid (found with ``binary_dilation`` at construction)."""

    def __init__(self, bad_channels: Sequence[int], grids: List[np.ndarray],
                 layout: np.ndarray):
        self.layout = np.asarray(layout)
        good_masks = [np.ones(grid.shape, dtype=bool) for grid in grids]
        for bc in bad_channels:
            gi = self._grid_index(bc, grids)
            good_masks[gi][grids[gi] == bc] = False

        footprint = np.ones((3, 3), dtype=bool)
        footprint[1, 1] = False

        self.patches = []
        for bc in bad_channels:
            gi = self._grid_index(bc, grids)
            grid = grids[gi]
            neighborhood = binary_dilation(grid == bc, structure=footprint) \
                & good_masks[gi]
            bad_idx = np.flatnonzero(self.layout == bc)
            nbr_idx = np.concatenate(
                [np.flatnonzero(self.layout == n) for n in grid[neighborhood]])
            self.patches.append((bad_idx, nbr_idx))
        self._device = None
        self._index: List = []

    @staticmethod
    def _grid_index(channel: int, grids: List[np.ndarray]) -> int:
        for i, grid in enumerate(grids):
            if channel in grid:
                return i
        raise IndexError("Channel could not be found in given grids.")

    def to(self, device) -> "BadChannelCorrection":
        self._device = torch.device(device)
        self._index = [
            (torch.as_tensor(b, device=device), torch.as_tensor(n, device=device))
            for b, n in self.patches]
        return self

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        if self._device != data.device:
            self.to(data.device)
        result = data.clone()
        for bad_idx, nbr_idx in self._index:
            mean = data.index_select(-1, nbr_idx).mean(-1, keepdim=True)
            result[..., bad_idx] = mean
        return result

    def __len__(self) -> int:
        return len(self.patches)

    def __repr__(self) -> str:
        items = [f"{int(self.layout[b][0])} -> "
                 f"{[int(self.layout[i]) for i in n]}"
                 for b, n in self.patches]
        return (f"Correcting {len(self.patches)} bad channels: "
                f"{', '.join(items)}")


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
