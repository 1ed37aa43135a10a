"""Sliding-window log power and the warm-start streaming framer
(counterpart of dss_tpu/ops/frames.py)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .log_power import LOG_POWER_EPS, log_power, log_power_gather, uniform_hop

__all__ = ["LOG_POWER_EPS", "num_windows", "window_starts", "log_power_frames",
           "StreamingFramer", "framer_step", "first_packet_warmup_frames"]


def num_windows(nb_samples: int, fs: int, window_length: float,
                window_shift: float) -> int:
    """floor((T - L) / H) + 1 with L/H in samples — the reference's count."""
    return int(np.floor((nb_samples - window_length * fs)
                        / (window_shift * fs))) + 1


def window_starts(nb_samples: int, fs: int, window_length: float,
                  window_shift: float) -> np.ndarray:
    """Static per-window start indices: round(w * shift * fs)."""
    n = num_windows(nb_samples, fs, window_length, window_shift)
    return np.round(np.arange(n) * window_shift * fs).astype(np.int64)


def log_power_frames(data: torch.Tensor, fs: int, window_length: float = 0.05,
                     window_shift: float = 0.01) -> torch.Tensor:
    """log(mean(x^2) + 0.01) per window and channel: [T, C] -> [W, C].

    Uniform geometry (starts from 0, hop dividing the window — the
    canonical 50 ms / 10 ms at 1 kHz) goes through the log-power kernel
    wrapper (the CUDA kernel for CUDA tensors, its plain version on the
    CPU); any other geometry takes the gather form."""
    starts = window_starts(data.shape[0], fs, window_length, window_shift)
    length = int(np.round(window_length * fs))
    if uniform_hop(starts, length) is not None:
        return log_power(data, starts, length)
    return log_power_gather(data, starts, length)


class StreamingFramer:
    """Warm-start frame buffer (host numpy): zero-pads a short first packet
    to one frame and prefixes every later packet with the carried
    ``frame_length - frame_shift`` remainder, so chunked framing equals one
    offline pass."""

    def __init__(self, frame_length: float, frame_shift: float, fs: int,
                 nb_channels: int):
        self.frame_length_in_samples = int(frame_length * fs)
        shift = int(frame_shift * fs)
        self.overlap = self.frame_length_in_samples - shift
        self.nb_channels = nb_channels
        self.reset()

    def reset(self) -> None:
        self.first_frame = True
        self.remainder = np.zeros((self.overlap, self.nb_channels))

    def insert(self, data: np.ndarray) -> np.ndarray:
        if self.first_frame:
            self.first_frame = False
            if data.shape[0] >= self.frame_length_in_samples:
                out = data
            else:
                pad = self.frame_length_in_samples - data.shape[0]
                out = np.concatenate(
                    [np.zeros((pad, data.shape[1]), dtype=data.dtype), data],
                    axis=0)
        else:
            out = np.concatenate([np.asarray(self.remainder), data], axis=0)
        self.remainder = out[-self.overlap:, :]
        return out

    def carry(self, nb_rows: int, like: torch.Tensor) -> torch.Tensor:
        """The rows ``insert`` would put before the next block of
        ``nb_rows`` rows, as a float32 tensor on ``like``'s device: none for
        a first block of at least one frame, zeros up to one frame for a
        short first block, the remainder after that.  Clears the first-frame
        flag; the caller stores the block's last ``overlap`` rows back into
        ``remainder``."""
        if self.first_frame:
            self.first_frame = False
            pad = max(self.frame_length_in_samples - nb_rows, 0)
            return torch.zeros((pad, like.shape[1]), dtype=torch.float32,
                               device=like.device)
        return torch.as_tensor(self.remainder, dtype=torch.float32,
                               device=like.device)


def framer_step(carry: torch.Tensor, packet: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming step: (remainder [overlap, C], packet [P, C]) ->
    (block [overlap + P, C], new remainder).  A zero first carry yields
    ``first_packet_warmup_frames`` extra leading frames the caller drops
    once."""
    block = torch.cat([carry, packet], dim=0)
    return block, block[-carry.shape[0]:, :]


def first_packet_warmup_frames(packet_size: int, fs: int,
                               window_length: float = 0.05,
                               window_shift: float = 0.01) -> int:
    """Leading frames of the first zero-carried ``framer_step`` that the
    reference warm start would not have produced."""
    length = int(np.round(window_length * fs))
    shift = int(np.round(window_shift * fs))
    overlap = length - shift
    ref_block = max(packet_size, length)
    ref_windows = (ref_block - length) // shift + 1
    ours = (overlap + packet_size - length) // shift + 1
    return ours - ref_windows
