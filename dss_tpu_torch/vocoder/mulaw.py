"""8-bit mu-law companding for the autoregressive sample domain
(counterpart of dss_tpu/vocoder/mulaw.py).

``mulaw_decode`` reads its 256 levels from one table: each the float32
nearest sign(y) (256^|y| - 1) / 255, computed once in float64, the same on
every device.  Evaluated in float32 on an NVIDIA H100, ``torch.pow`` put
levels up to 7.2e-7 away from these, so the plain sampler loop on the card
drifted from the sampler kernel, which computes the same levels in double
precision."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

MULAW_LEVELS = 256
_MU = 255.0
_LOG1P_MU = math.log1p(_MU)


def mulaw_encode(x: torch.Tensor) -> torch.Tensor:
    """Float signal in [-1, 1] -> integer level in [0, 255] (int64)."""
    x = x.clamp(-1.0, 1.0)
    y = torch.sign(x) * torch.log1p(_MU * x.abs()) / _LOG1P_MU
    return torch.round((y + 1.0) * 0.5 * (MULAW_LEVELS - 1)).clamp(
        0, MULAW_LEVELS - 1).long()


_y = np.arange(MULAW_LEVELS) / (MULAW_LEVELS - 1) * 2.0 - 1.0
LEVELS = (np.sign(_y) * (np.power(1.0 + _MU, np.abs(_y)) - 1.0) / _MU
          ).astype(np.float32)
_levels: Dict[torch.device, torch.Tensor] = {}


def mulaw_decode(idx: torch.Tensor) -> torch.Tensor:
    """Integer level in [0, 255] -> float32 signal in [-1, 1]."""
    table = _levels.get(idx.device)
    if table is None:
        table = _levels[idx.device] = torch.as_tensor(LEVELS,
                                                      device=idx.device)
    return table[idx.long()]
