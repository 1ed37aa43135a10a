"""Checkpoint helpers of the vocoder API (counterpart of the parts of
dss_tpu/vocoder/lpcnet.py the online word path uses)."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.sampler import tile_sparse_pattern


def _load_params(weights, device) -> Optional[Dict[str, torch.Tensor]]:
    """A checkpoint (``.npz`` path, or a dict of arrays) as a dict of
    tensors on ``device``; None passes through."""
    if weights is None:
        return None
    if isinstance(weights, str) or hasattr(weights, "__fspath__"):
        with np.load(os.fspath(weights)) as f:
            weights = {k: f[k] for k in f.files}
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in weights.items()}


def _sparse_pattern_of(params):
    """(tile keep-pattern, kept fraction) of the GRU-A recurrent mask at
    [16 x 128] tiles, or (None, 1.0) when the mask is dense or absent."""
    if params is None or "gru_a_mask" not in params:
        return None, 1.0
    return tile_sparse_pattern(params["gru_a_mask"].detach().cpu().numpy())
