"""The device trace (counterpart of dss_tpu/utils/profiling.py's
``device_trace``).

* ``device_trace(log_dir)`` records a ``torch.profiler`` trace of a region
  and writes it into ``log_dir`` as a Chrome trace (``*.pt.trace.json``,
  which TensorBoard's profiler plugin and chrome://tracing read).  It
  records the CPU ops of every thread, not only the caller's: the units run
  their device calls on one-worker executor threads.  On the card it also
  records every CUDA kernel (CUPTI), and a trace that holds none is an
  error, not a CPU-only trace.  The span recorder (utils/tracing.py) is on
  for the region, and its spans go into the same trace as ``X`` events of
  category ``host_span`` on the trace's clock, on their threads' rows.
* ``trace_summary(path)`` reads such a trace back: the kernels by name, the
  CPU ops and kernels of each thread, the host spans by name, and the
  device's busy share.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import os
import socket
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..device import resolve_device
from . import tracing

logger = logging.getLogger("dss_tpu_torch.profiling")

# Chrome-trace categories of device work, and of the CPU-side calls that
# launch it (the runtime API, and the driver API below it).
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def device_trace(log_dir: str, device=None) -> Iterator[None]:
    """Record a torch.profiler trace of the region into ``log_dir``: the
    CPU ops of every thread, the host spans of the region (the recorder is
    switched on for it, then off, and drained into the trace) and, on
    ``cuda`` (the default), the CUDA kernels.  Raises when the card's
    profiler (CUPTI) is missing, and after the region when the trace holds
    no CUDA kernel."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("device_trace: this torch build cannot trace "
                               "CUDA kernels (no CUPTI)")
        activities.append(ProfilerActivity.CUDA)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities, experimental_config=config)
    tracing.drain()
    tracing.enable()
    anchor = tracing.Anchor()
    prof.start()
    try:
        yield
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        tracing.disable()
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fd:
        trace = json.load(fd)
    trace["traceEvents"] += tracing.chrome_events(
        tracing.drain(), anchor, trace["baseTimeNanoseconds"], os.getpid())
    with open(path, "w") as fd:
        json.dump(trace, fd)
    logger.info(f"torch profiler trace written to {path}")
    if dev.type == "cuda" and trace_summary(path)["kernels"] == 0:
        raise RuntimeError(f"device_trace: {path} holds no CUDA kernel "
                           f"event")


def trace_files(log_dir: str) -> List[str]:
    """The traces ``device_trace`` wrote into ``log_dir``, oldest first."""
    return sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")),
                  key=os.path.getmtime)


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def trace_summary(path: str, top: int = 10) -> Dict[str, object]:
    """What a Chrome trace of ``device_trace`` holds:

    * ``kernels``: CUDA kernel events; ``by_name``: name -> [count, device
      us], the ``top`` names with the most device time;
    * ``busy_share``: the union of kernel, copy and memset intervals over
      the traced span (``span_us``: the profiler's own span, else the first
      to the last event), and ``kernel_us``, the kernels' summed time;
    * ``threads``: per CPU thread (the system's id) its CPU op events
      (``cpu_ops``), the kernels it launched (``kernels``, joined to the
      launch call through its correlation id) and their names with counts
      (``kernel_names``, cut to 100 characters);
    * ``spans``: the host spans (category ``host_span``) by name, counted."""
    with open(path) as fd:
        events = [e for e in json.load(fd)["traceEvents"]
                  if e.get("ph") == "X"]
    span = [e for e in events if e.get("cat") == "Trace"]
    if span:
        t0, t1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    else:
        t0 = min((e["ts"] for e in events), default=0.0)
        t1 = max((e["ts"] + e.get("dur", 0) for e in events), default=0.0)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e.get("dur", 0)
    threads: Dict[object, Dict] = defaultdict(
        lambda: dict(cpu_ops=0, kernels=0, kernel_names=defaultdict(int)))
    for e in events:
        if e.get("cat") == "cpu_op":
            threads[e["tid"]]["cpu_ops"] += 1
    launcher = {e["args"]["correlation"]: e["tid"] for e in events
                if e.get("cat") in _LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    for e in kernels:
        t = threads[launcher.get(e.get("args", {}).get("correlation"))]
        t["kernels"] += 1
        t["kernel_names"][e["name"][:100]] += 1
    busy = _busy_us([(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                     if e.get("cat") in _DEVICE_CATS])
    spans: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("cat") == tracing.SPAN_CATEGORY:
            spans[e["name"]] += 1
    return dict(
        kernels=len(kernels), span_us=t1 - t0, busy_us=busy,
        busy_share=busy / (t1 - t0) if t1 > t0 else None,
        kernel_us=sum(e.get("dur", 0) for e in kernels),
        by_name=dict(sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]),
        threads={tid: dict(t, kernel_names=dict(t["kernel_names"]))
                 for tid, t in threads.items()},
        spans=dict(spans))

