"""The packet front end in one kernel: IIR cascade + warm-start framing +
log power (csrc/filter_log_power.cu) and its plain PyTorch version.

Replaces, on the packet path, the JAX package's sequential cascade
(dss_tpu/ops/filters.py:166-194, ``sosfilt_scan``) and its Pallas log-power
kernel (dss_tpu/ops/pallas/log_power.py:32, ``_log_power_kernel``), which
``HighGammaExtractor.packet_step`` jits into one XLA program per packet.
Eagerly, the cascade is a wavefront of T + S - 1 steps of tiny launches
(~800 a 40-sample packet) and the log power one more launch: the host
bounds them, not the card.  The kernel runs the whole step in one launch;
on the card its own time is the cascade's serial chain (16 sections x T
samples per channel), see the source's note.

The wrapper runs on every packet, so it stays lean: shape checks are cached
per shape, outputs come from ``torch.empty``, and nothing syncs the host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from . import _cuda
from .filters import sosfilt_scan
from .log_power import LOG_POWER_EPS, log_power_plain

MAX_SECTIONS = 64   # kMaxSections in the source
MAX_CARRY = 256     # kMaxCarry: carried rows staged in shared memory
MAX_GROUPS = 16     # kMaxGroups: length / hop, the ring of group sums


def _num_windows(nb_rows: int, hop: int, length: int) -> int:
    return (nb_rows - length) // hop + 1 if nb_rows >= length else 0


def filter_log_power_plain(sos: torch.Tensor, x: torch.Tensor,
                           zi: torch.Tensor, carry: torch.Tensor, hop: int,
                           length: int):
    """Plain version of the kernel: ``sosfilt_scan``, the carried rows put
    before the filtered ones, then ``log_power_plain`` over windows of
    ``length`` at ``hop``.  Returns (features [W, C], zf [S, 2, C], the
    last ``length - hop`` rows of the block)."""
    y, zf = sosfilt_scan(sos, x, zi)
    block = torch.cat([carry, y], dim=0)
    n = block.shape[0]
    features = log_power_plain(block, hop, length, _num_windows(n, hop, length))
    return features, zf, block[n - (length - hop):]


@lru_cache(maxsize=1024)
def _geometry(x_shape, sos_shape, zi_shape, carry_shape, hop: int,
              length: int) -> Tuple[int, int]:
    """(windows, carried rows out) for these shapes; raises on what the
    kernel does not take.  Cached: the packet path sees a few shapes."""
    if len(x_shape) != 2 or x_shape[0] < 1:
        raise ValueError(f"filter_log_power: x must be [T >= 1, C], got "
                         f"{tuple(x_shape)}")
    T, C = x_shape
    S = sos_shape[0] if len(sos_shape) == 2 else -1
    if tuple(sos_shape) != (S, 6) or not 1 <= S <= MAX_SECTIONS:
        raise ValueError(f"filter_log_power: sos must be [S <= {MAX_SECTIONS},"
                         f" 6], got {tuple(sos_shape)}")
    if tuple(zi_shape) != (S, 2, C):
        raise ValueError(f"filter_log_power: zi must be [{S}, 2, {C}], got "
                         f"{tuple(zi_shape)}")
    if len(carry_shape) != 2 or carry_shape[1] != C or \
            carry_shape[0] > MAX_CARRY:
        raise ValueError(f"filter_log_power: carry must be [R <= {MAX_CARRY}"
                         f", {C}], got {tuple(carry_shape)}")
    if hop < 1 or length % hop or length // hop > MAX_GROUPS:
        raise ValueError(f"filter_log_power: hop {hop} must divide the window "
                         f"length {length} at most {MAX_GROUPS} times")
    n = carry_shape[0] + T
    if n < length - hop:
        raise ValueError(f"filter_log_power: {carry_shape[0]} carried + {T} "
                         f"new rows are fewer than the {length - hop} to "
                         f"carry out")
    return _num_windows(n, hop, length), length - hop


def filter_log_power(sos: torch.Tensor, x: torch.Tensor, zi: torch.Tensor,
                     carry: torch.Tensor, hop: int, length: int):
    """One packet step of the front end after the pre-transforms: the
    cascade ``sos`` [S, 6] over x [T, C] from state zi [S, 2, C], the
    carried rows carry [R, C] (R may be 0) put before the filtered ones, and
    log(mean(x^2) + 0.01) over windows of ``length`` at ``hop``.  Returns
    (features [W, C], zf [S, 2, C], carry_out [length - hop, C]).

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    All inputs must be float32 on one device."""
    num_win, keep = _geometry(x.shape, sos.shape, zi.shape, carry.shape,
                              hop, length)
    for t in (x, sos, zi, carry):
        if t.dtype != torch.float32:
            raise TypeError(f"filter_log_power: needs float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"filter_log_power: tensors on {t.device} and "
                             f"{x.device}")
    if x.device.type == "cpu":
        return filter_log_power_plain(sos, x, zi, carry, hop, length)
    if x.device.type != "cuda":
        raise TypeError(f"filter_log_power: needs a CUDA or CPU tensor, got "
                        f"{x.device}")
    x, sos, zi, carry = (t.contiguous() for t in (x, sos, zi, carry))
    T, C = x.shape
    features = torch.empty((num_win, C), dtype=torch.float32, device=x.device)
    zf = torch.empty_like(zi)
    carry_out = torch.empty((keep, C), dtype=torch.float32, device=x.device)
    rc = _cuda.library().dss_filter_log_power(
        x.data_ptr(), sos.data_ptr(), zi.data_ptr(), carry.data_ptr(),
        features.data_ptr(), zf.data_ptr(), carry_out.data_ptr(), T, C,
        sos.shape[0], carry.shape[0], hop, length, LOG_POWER_EPS,
        _cuda.stream_ptr(x))
    _cuda.check(rc, "filter_log_power")
    filter_log_power.launches += 1
    return features, zf, carry_out


filter_log_power.launches = 0

