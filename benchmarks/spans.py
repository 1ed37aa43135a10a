"""The port's host spans (dss_tpu_torch/utils/tracing.py) read beside the
device trace of a run's window: each device operation joined to the span
that launched it, the span metrics, and the longest idle gaps named by
what the host was doing.

The input is one list of Chrome-trace events: the profiler's (device
operations, and the runtime's launch calls with their correlation ids and
threads) and the spans as the program writes them into a trace
(``tracing.chrome_events``: ``X`` events of category ``host_span`` on the
trace's clock, ``args`` holding ``id``, ``parent``, ``key`` and counts).

A device operation is joined through its correlation id to its launch
call, then to the innermost span open on the launching thread when the
call began.  A trace with CPU activity names that thread by its native id,
a trace of CUDA activity alone by its pthread id cut to 32 bits; a span
carries both (``tid`` and ``args["ident"]``).  ``graph.wait`` spans (a message waiting on an edge) are not
host work: no operation joins to one, and no gap is named by one."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from .common import union_length

SPAN_CAT = "host_span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WAIT = "graph.wait"
FE_EDGE = "FusedFrontendVad.INPUT"


def spans_of(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") == SPAN_CAT]


def device_ops(events: List[dict]) -> List[dict]:
    return sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                  key=lambda e: e["ts"])


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def _end(e) -> float:
    return e["ts"] + e.get("dur", 0.0)


def innermost(spans: List[dict], queries) -> List[Optional[dict]]:
    """For each (tid, t) of ``queries`` the innermost span open on thread
    tid at t (started at or before t, not yet ended), or None.  Spans of a
    thread nest, so one sweep a thread with a stack of open spans
    answers every query."""
    by_tid: Dict[object, List[dict]] = defaultdict(list)
    for s in spans:
        if s["name"] != WAIT:
            by_tid[s["tid"]].append(s)
            if "ident" in s["args"]:
                by_tid[s["args"]["ident"]].append(s)
    for v in by_tid.values():
        v.sort(key=lambda s: (s["ts"], -s.get("dur", 0.0)))
    order = sorted(range(len(queries)), key=lambda i: (queries[i][0] is None,
                                                       str(queries[i][0]),
                                                       queries[i][1]))
    out: List[Optional[dict]] = [None] * len(queries)
    tid, stack, pending, k = object(), [], [], 0
    for i in order:
        q_tid, t = queries[i]
        if q_tid != tid:
            tid, stack, pending, k = q_tid, [], by_tid.get(q_tid, []), 0
        while k < len(pending) and pending[k]["ts"] <= t:
            s = pending[k]
            while stack and _end(stack[-1]) <= s["ts"]:
                stack.pop()
            stack.append(s)
            k += 1
        while stack and _end(stack[-1]) <= t:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def join(events: List[dict]) -> List[tuple]:
    """(device operation, the span that launched it or None) for every
    device operation; None also where its launch call is not in the trace."""
    ops = device_ops(events)
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    calls = [launch.get(op.get("args", {}).get("correlation")) for op in ops]
    found = innermost(spans_of(events), [(c["tid"], c["ts"]) if c else
                                         (None, 0.0) for c in calls])
    return [(op, s if c is not None else None)
            for op, c, s in zip(ops, calls, found)]


def launched_by(joined: List[tuple], spans: List[dict],
                name: str) -> Dict[int, List[dict]]:
    """Span id of each span named ``name`` -> the device operations
    launched inside it (in it or in a span below it)."""
    by_id = {s["args"]["id"]: s for s in spans}
    out: Dict[int, List[dict]] = {s["args"]["id"]: []
                                  for s in spans if s["name"] == name}
    for op, s in joined:
        while s is not None:
            if s["name"] == name:
                out[s["args"]["id"]].append(op)
                break
            s = by_id.get(s["args"].get("parent"))
    return out


def _median(values) -> Optional[float]:
    v = list(values)
    return float(np.median(v)) if v else None


def fe_wait_ms(spans: List[dict]) -> List[float]:
    """Per packet: the start of the packet call that carries it minus the
    start of its wait on the packet path's edge.  A call carries
    ``packets`` packets in order from the one whose ``received_at`` is its
    key."""
    waits = sorted((s for s in _named(spans, WAIT)
                    if s["args"].get("edge") == FE_EDGE),
                   key=lambda s: s["args"]["key"])
    keys = [w["args"]["key"] for w in waits]
    out = []
    for call in _named(spans, "units.fe_call"):
        i = bisect.bisect_left(keys, call["args"].get("key"))
        if i == len(keys) or keys[i] != call["args"].get("key"):
            continue   # its packets were taken before the recorder was on
        for w in waits[i:i + call["args"]["packets"]]:
            out.append((call["ts"] - w["ts"]) * 1e-3)
    return out


def packet_path(spans: List[dict]) -> Dict[str, Optional[float]]:
    """Medians over the packets (ms) of the packet path's steps a packet
    takes: its wait on the packet path's edge (``wait``), the wait's end to
    the start of the call that carries it (``to_call``: the coalesced
    batch and the executor hop), the call (``call``), the call's end to
    its ``units.fe_segment`` (``to_segment``: the hop back to the event
    loop), that segment (``segment``) and the wait of its features on the
    feature tap's edge (``tap_wait``)."""
    def by_key(name, edge=None):
        return {s["args"].get("key"): s for s in _named(spans, name)
                if edge is None or s["args"].get("edge") == edge}

    waits = by_key(WAIT, FE_EDGE)
    calls = by_key("units.fe_call")
    segs = by_key("units.fe_segment")
    tap = {s["args"].get("key"): s for s in _named(spans, WAIT)
           if s["args"].get("edge") not in (FE_EDGE, None)
           and s["args"]["edge"].startswith("FeatureTap")}
    keys = sorted(waits)
    rows = defaultdict(list)
    for key, call in calls.items():
        i = bisect.bisect_left(keys, key)
        for k in keys[i:i + call["args"]["packets"]]:
            w = waits[k]
            rows["wait"].append(w["dur"])
            rows["to_call"].append(call["ts"] - _end(w))
            rows["call"].append(call["dur"])
            if key in segs:
                rows["to_segment"].append(segs[key]["ts"] - _end(call))
                rows["segment"].append(segs[key]["dur"])
            if key in tap:
                rows["tap_wait"].append(tap[key]["dur"])
    return {k: _median(v) * 1e-3 for k, v in rows.items()}


def span_medians(spans: List[dict]) -> Dict[str, float]:
    """Each span name's median duration (ms) and count."""
    names = sorted({s["name"] for s in spans})
    return {n: [_median(durations_ms(spans, n)), len(_named(spans, n))]
            for n in names}


def durations_ms(spans: List[dict], name: str, words_only=False):
    return [s["dur"] * 1e-3 for s in _named(spans, name)
            if not words_only or s["args"].get("key") is not None]


def head_intervals(spans: List[dict]) -> List[tuple]:
    """Per word, the head's interval on the trace's clock: its
    ``units.word_head`` (fused word path), or from its ``units.decode``
    start to its ``units.vocode`` end (the separate chain)."""
    heads = [(s["ts"], _end(s)) for s in _named(spans, "units.word_head")]
    if heads:
        return heads
    vocode = {s["args"].get("key"): s for s in _named(spans, "units.vocode")}
    return [(d["ts"], _end(vocode[d["args"]["key"]]))
            for d in _named(spans, "units.decode")
            if d["args"].get("key") in vocode]


def idle_inside(ops: List[dict], a: float, b: float) -> float:
    """Time of [a, b] in which no device operation ran."""
    busy = union_length((max(o["ts"], a), min(_end(o), b)) for o in ops
                        if o["ts"] < b and _end(o) > a)
    return (b - a) - busy


def span_metrics(events: List[dict]) -> Dict[str, Optional[float]]:
    """The span metrics of a window (None where the window has nothing to
    read).  Times in ms."""
    spans = spans_of(events)
    ops = device_ops(events)
    joined = join(events) if ops else []
    decode_ops = launched_by(joined, spans, "models.decode")
    words = [s for s in _named(spans, "models.decode")
             if s["args"].get("key") is not None]
    noise = launched_by(joined, spans, "vocoder.noise")
    synth = _named(spans, "vocoder.synth")
    return {
        "graph.fe_wait_ms_p50": _median(fe_wait_ms(spans)),
        "units.fe_launch_ms_p50": _median(durations_ms(spans,
                                                       "units.fe_launch")),
        "models.decode_launch_ms_p50": _median(
            durations_ms(spans, "models.decode", words_only=True)),
        "models.decode_kernels_p50": _median(
            len(decode_ops[s["args"]["id"]]) for s in words)
        if ops and words else None,
        "device.word_head_idle_ms_p50": _median(
            idle_inside(ops, a, b) * 1e-3 for a, b in head_intervals(spans))
        if ops else None,
        "vocoder.noise_ms_per_step": sum(
            o.get("dur", 0.0) for v in noise.values() for o in v) * 1e-3
        / len(synth) if ops and synth and noise else None,
        "vocoder.launch_ms_per_step": sum(s["dur"] for s in synth) * 1e-3
        / len(synth) if synth else None,
    }


def idle_gaps(events: List[dict], top: int = 10) -> List[list]:
    """The ``top`` longest gaps between device operations, each named as
    ``benchmarks/trace.py`` names it (the operations before and after) and
    then by the innermost host span open at its midpoint on any thread
    (the latest begun): ``... | host: <span or none>``."""
    ops = device_ops(events)
    gaps, end, last = [], None, None
    for o in ops:
        t, d, name = o["ts"], o.get("dur", 0.0), o["name"]
        if end is not None and t > end:
            gaps.append((t - end, (end + t) / 2,
                         f"{last[:60]} -> {name[:60]}"))
        if end is None or t + d > end:
            end, last = t + d, name
    gaps.sort(reverse=True)
    gaps = gaps[:top]
    spans = spans_of(events)
    tids = sorted({s["tid"] for s in spans}, key=str)
    out = []
    for us, mid, label in gaps:
        open_ = [s for s in innermost(spans, [(t, mid) for t in tids])
                 if s is not None]
        host = max(open_, key=lambda s: s["ts"])["name"] if open_ \
            else "none"
        out.append([f"{label} | host: {host}", us * 1e-6])
    return out
