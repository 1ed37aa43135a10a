"""Message types flowing through the streaming graph (a copy of
dss_tpu/runtime/messages.py).

Parity targets: ezmsg.eeg's ``TimeSeriesMessage`` (the reference's message
base) and the reference's ``ClosedLoopMessage`` extension
(local/units.py:29-35) carrying the ingest wall-clock timestamp and a
cumulative frame counter for latency/alignment bookkeeping.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class TimeSeriesMessage:
    data: np.ndarray
    fs: float = 1.0
    time_dim: int = 0

    @property
    def n_time(self) -> int:
        return self.data.shape[self.time_dim]


@dataclass
class ClosedLoopMessage(TimeSeriesMessage):
    """Adds closed-loop bookkeeping: when the packet entered the system and
    how many feature frames preceded this message."""

    received_at: Optional[float] = None
    previous_frames: Optional[float] = None
    # Per-stage wall-clock stamps appended as the message flows through the
    # graph: ((stage_name, time.time()), ...).  Together with received_at
    # they decompose the end-to-end ingest->audio latency into a per-stage
    # budget (aggregated by DelayedStdoutForSoX at shutdown).  Stage names
    # ending in "_device_done" mark the end of a device call whose one
    # device->host read is its last step (the budget counts them as the
    # word's device round trips).
    stamps: Tuple[Tuple[str, float], ...] = ()
