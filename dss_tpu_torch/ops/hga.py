"""High-gamma feature front end: filter cascade + framing + log power
(counterpart of dss_tpu/ops/hga.py).

The band-pass (70-170 Hz) and band-stop (118-122 Hz) filters run as one
16-section cascade.  Where the window geometry is uniform (hop dividing the
window, both whole samples: always at 50 ms / 10 ms) the cascade, the
framing and the log power are one call of ``filter_log_power`` (one kernel
launch on the card); any other geometry takes the eager cascade and
``log_power_frames``.  The front-end kernel is the cascade at every block
length: the JAX extractor's ``parallel_filter=True`` (each section as a
prefix scan in its modal basis, for long offline blocks on the TPU)
computes the same function, so here the flag is accepted and changes
nothing (a torch port of the parallel scan ran ~300x slower than the
kernel on an NVIDIA H100).  The cascade's
initial state is each filter's own ``sosfilt_zi`` concatenated along the
section axis — not the ``zi`` of the combined cascade — because the
reference runs the two filters back to back with independently initialized
states.
"""

from __future__ import annotations

import logging
from functools import reduce
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .filter_log_power import filter_log_power
from .filters import design_bandpass, design_bandstop, sosfilt_scan, sosfilt_zi
from .frames import StreamingFramer, first_packet_warmup_frames, \
    framer_step, log_power_frames

logger = logging.getLogger("dss_tpu_torch.ops.hga")

Transforms = Optional[List[Callable]]


def _compose(functions: Transforms) -> Optional[Callable]:
    if not functions:
        return None
    return reduce(lambda f, g: lambda x: g(f(x)), functions, lambda x: x)


def _uniform_geometry(fs: int, window_length: float, window_shift: float,
                      overlap: int) -> Optional[Tuple[int, int]]:
    """(hop, length) in samples when both are whole samples, the hop divides
    the window and the framer carries length - hop rows; else None."""
    hop = int(round(window_shift * fs))
    length = int(round(window_length * fs))
    whole = abs(hop - window_shift * fs) < 1e-9 and \
        abs(length - window_length * fs) < 1e-9
    if whole and hop > 0 and length % hop == 0 and overlap == length - hop:
        return hop, length
    return None


class FrontendState(NamedTuple):
    """Carried streaming state: IIR section states + framer remainder."""

    zi: torch.Tensor         # [S, 2, C]
    remainder: torch.Tensor  # [overlap, C]


class HighGammaExtractor:
    """Front end with the reference's stateful ``extract_features`` and the
    explicit-state ``init_state`` / ``packet_step`` used online."""

    def __init__(self, fs: int, nb_electrodes: int,
                 window_length: float = 0.05, window_shift: float = 0.01,
                 l_freq: int = 70, h_freq: int = 170,
                 pre_transforms: Transforms = None,
                 post_transforms: Transforms = None,
                 device=None, parallel_filter: bool = False):
        self.parallel_filter = parallel_filter  # the kernel serves both
        self.device = resolve_device(device)
        self.fs = fs
        self.nb_electrodes = nb_electrodes
        self.window_length = window_length
        self.window_shift = window_shift
        for t in (pre_transforms or []) + (post_transforms or []):
            if hasattr(t, "to"):
                t.to(self.device)
        self.pre_transform = _compose(pre_transforms)
        self.post_transform = _compose(post_transforms)

        if not ((60 < l_freq < 120) or (120 < h_freq < 180)):
            logger.warning("band edges (%s-%s Hz) fall outside the usual "
                           "high-gamma range", l_freq, h_freq)
        bp = design_bandpass(fs, l_freq, h_freq, order=8)
        bs = design_bandstop(fs, 118, 122, order=8)
        self.sos_np = np.concatenate([bp, bs], axis=0)
        self.sos = torch.as_tensor(self.sos_np, dtype=torch.float32,
                                   device=self.device)
        self._zi0 = np.concatenate(
            [sosfilt_zi(bp, nb_electrodes), sosfilt_zi(bs, nb_electrodes)],
            axis=0)
        self.framebuffer = StreamingFramer(
            frame_length=window_length, frame_shift=window_shift, fs=fs,
            nb_channels=nb_electrodes)
        self._uniform = _uniform_geometry(fs, window_length, window_shift,
                                          self.framebuffer.overlap)
        self.reset()

    # -- reference-compatible stateful API --------------------------------
    def reset(self) -> None:
        self.zi = torch.as_tensor(self._zi0, dtype=torch.float32,
                                  device=self.device)
        self.framebuffer.reset()

    def extract_features(self, data: np.ndarray) -> np.ndarray:
        """Streaming/offline extraction with carried state:
        [T, raw_channels] -> [num_windows, features] (numpy)."""
        x = torch.as_tensor(np.asarray(data, np.float32), device=self.device)
        if self.pre_transform is not None:
            x = self.pre_transform(x)
        if self._uniform is not None:
            carry = self.framebuffer.carry(x.shape[0], x)
            features, self.zi, self.framebuffer.remainder = filter_log_power(
                self.sos, x, self.zi, carry, *self._uniform)
        else:
            filtered, self.zi = sosfilt_scan(self.sos, x, self.zi)
            block = torch.as_tensor(
                self.framebuffer.insert(filtered.cpu().numpy()),
                dtype=torch.float32, device=self.device)
            features = log_power_frames(block, self.fs, self.window_length,
                                        self.window_shift)
        if self.post_transform is not None:
            features = self.post_transform(features)
        return features.cpu().numpy()

    # -- explicit-state API for the online runtime -------------------------
    def init_state(self) -> FrontendState:
        return FrontendState(
            zi=torch.as_tensor(self._zi0, dtype=torch.float32,
                               device=self.device),
            remainder=torch.zeros((self.framebuffer.overlap,
                                   self.nb_electrodes), device=self.device))

    def warmup_frames(self, packet_size: int) -> int:
        """Leading frames to drop from the first ``packet_step`` output."""
        return first_packet_warmup_frames(packet_size, self.fs,
                                          self.window_length,
                                          self.window_shift)

    def packet_step(self, state: FrontendState, packet: torch.Tensor):
        """One streaming step: packet [P, raw_ch] -> (features [W, F], new
        state).  The first call's output holds ``warmup_frames(P)`` extra
        leading frames."""
        data = packet.to(self.device, torch.float32)
        if self.pre_transform is not None:
            data = self.pre_transform(data)
        if self._uniform is not None:
            features, zi, remainder = filter_log_power(
                self.sos, data, state.zi, state.remainder, *self._uniform)
        else:
            filtered, zi = sosfilt_scan(self.sos, data, state.zi)
            block, remainder = framer_step(state.remainder, filtered)
            features = log_power_frames(block, self.fs, self.window_length,
                                        self.window_shift)
        if self.post_transform is not None:
            features = self.post_transform(features)
        return features, FrontendState(zi=zi, remainder=remainder)
