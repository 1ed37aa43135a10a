"""Log power per window and channel: the CUDA kernel (csrc/log_power.cu)
and its plain PyTorch version.

Counterpart of dss_tpu/ops/pallas/log_power.py (``log_power_pallas``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda

LOG_POWER_EPS = 0.01


def log_power_gather(data: torch.Tensor, starts: np.ndarray,
                     length: int) -> torch.Tensor:
    """log(mean(x^2) + eps) over windows ``data[s:s+length]`` for each
    start: the gather form, valid for any window geometry."""
    idx = torch.as_tensor(starts[:, None] + np.arange(length)[None, :],
                          dtype=torch.long, device=data.device)
    power = torch.mean(torch.square(data[idx]), dim=1)   # [W, C]
    return torch.log(power + LOG_POWER_EPS)


def uniform_hop(starts: np.ndarray, length: int):
    """The hop of uniformly strided starts from 0 whose hop divides the
    window length, or None when the geometry is not of that kind (the rule
    of ``log_power_pallas``)."""
    if len(starts) == 0 or starts[0] != 0:
        return None
    if len(starts) == 1:
        return length
    hop = int(starts[1] - starts[0])
    if hop <= 0 or length % hop != 0 or not bool(np.all(np.diff(starts)
                                                         == hop)):
        return None
    return hop


def log_power_plain(data: torch.Tensor, hop: int, length: int,
                    num_win: int) -> torch.Tensor:
    """Plain version of the kernel: windows of ``length`` at ``hop``."""
    return log_power_gather(data, np.arange(num_win) * hop, length)


def log_power(data: torch.Tensor, starts: np.ndarray,
              length: int) -> torch.Tensor:
    """Log-power features [W, C] of ``data`` [N, C] for windows of
    ``length`` samples at ``starts`` (uniform from 0, hop dividing the
    length).  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    num_win = len(starts)
    hop = uniform_hop(starts, length)
    if hop is None:
        raise ValueError("log_power requires uniform starts from 0 with hop "
                         "dividing the window length")
    if data.dim() != 2 or (num_win - 1) * hop + length > data.shape[0]:
        raise ValueError(f"log_power: data {tuple(data.shape)} too short for "
                         f"{num_win} windows of {length} at hop {hop}")
    if data.device.type == "cpu":
        return log_power_plain(data, hop, length, num_win)
    if data.device.type != "cuda" or data.dtype != torch.float32:
        raise TypeError("log_power: needs a float32 CUDA or CPU tensor")
    data = data.contiguous()
    out = torch.empty((num_win, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    if num_win == 0:
        return out
    rc = _cuda.library().dss_log_power(
        data.data_ptr(), out.data_ptr(), data.shape[1], num_win, hop, length,
        LOG_POWER_EPS, _cuda.stream_ptr(data))
    _cuda.check(rc, "log_power")
    log_power.launches += 1
    return out


log_power.launches = 0
