"""8-bit mu-law companding for the autoregressive sample domain
(counterpart of dss_tpu/vocoder/mulaw.py)."""

from __future__ import annotations

import math

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


def mulaw_decode(idx: torch.Tensor) -> torch.Tensor:
    """Integer level in [0, 255] -> float signal in [-1, 1]."""
    y = idx.float() / (MULAW_LEVELS - 1) * 2.0 - 1.0
    return torch.sign(y) * (torch.pow(1.0 + _MU, y.abs()) - 1.0) / _MU
