"""The device trace of a run's window: torch.profiler (CUPTI) records every
kernel, copy and memset the card runs, from every thread of the process.
The Chrome trace goes to a file under the run's directory, is read back at
once and deleted.  What is kept: each device operation's name, start and
duration, and the launch calls on the host (for naming idle gaps)."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

from .common import union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceTrace:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self._prof = None
        self._running = False
        self.summary: Optional[dict] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._cuda = torch.cuda.is_available()
        self._prof = profile(activities=[ProfilerActivity.CUDA if self._cuda
                                         else ProfilerActivity.CPU])
        self._prof.start()
        self._running = True

    def stop(self) -> None:
        import torch
        if self._cuda:
            torch.cuda.synchronize()
        self._prof.stop()
        self._running = False

    def close(self) -> None:
        """Stop a trace a failed run left running."""
        if self._prof is not None and self._running:
            self._prof.stop()
        self._prof = None

    def finish(self, window_s: float) -> dict:
        """Read the stopped trace: -> its summary over ``window_s``."""
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "window.pt.trace.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        try:
            with open(path) as fd:
                events = [e for e in json.load(fd)["traceEvents"]
                          if e.get("ph") == "X"]
        finally:
            os.remove(path)
        self.summary = summarize(events, window_s)
        return self.summary


def summarize(events: List[dict], window_s: float) -> dict:
    """Device operations by name, their busy union, the top operations and
    the longest idle gaps (named by the device operations around them)."""
    ops = sorted(((e["ts"], e.get("dur", 0.0), e["name"]) for e in events
                  if e.get("cat") in DEVICE_CATS), key=lambda o: o[0])
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for _, dur, name in ops:
        by_name[name][0] += 1
        by_name[name][1] += dur
    busy_us = union_length((t, t + d) for t, d, _ in ops)
    gaps, end, last = [], None, None
    for t, d, name in ops:
        if end is not None and t > end:
            gaps.append((t - end, f"{last[:60]} -> {name[:60]}"))
        if end is None or t + d > end:
            end, last = t + d, name
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "by_name": {k: (int(v[0]), v[1] * 1e-6) for k, v in by_name.items()},
        "device_ops": [[k[:120], v[1] * 1e-6] for k, v in top],
        "idle_gaps": [[name, us * 1e-6] for us, name in gaps[:10]],
    }


def device_seconds(summary: dict, pattern: str):
    """(launches, seconds) of the device operations whose name holds
    ``pattern``."""
    n, s = 0, 0.0
    for name, (count, sec) in summary["by_name"].items():
        if pattern in name:
            n += count
            s += sec
    return n, s
