"""Spans of the port's host work, on one clock with the device trace.

``span(name, parent=None, key=None, **counts)`` is a context manager around
one piece of host work.  The recorder is off until ``enable()``: ``span``
then returns one shared no-op context, which reads no clock and records
nothing.  On, each span that closes leaves one ``Record``:

* ``name``, ``id`` (the span's own number) and ``parent`` (its parent's
  ``id``: the innermost span open on the same thread, or the span passed as
  ``parent``, which is how a span crosses an executor hop);
* ``key``: the packet or word the work is for (a packet's ``received_at``,
  a word's segment ``previous_frames``, the index of its first frame in the
  session's feature stream), inherited from the parent when not given;
* ``tid`` (``threading.get_native_id()``), ``start_ns`` and ``end_ns``
  (``time.perf_counter_ns()``) and ``counts``, the numbers given;
* ``ident``: the thread's ``threading.get_ident()`` (its pthread id); a
  trace of CUDA activity alone names a launch call's thread by it, cut to
  a signed 32 bits and made positive (``trace_thread``).

``record(name, start_ns, ...)`` closes a span whose start was taken earlier
with ``now()``, with no parent: a message's wait on a graph edge, which
starts in one coroutine and ends in another, or work on the event loop
that spans awaits (a span held open there would be the parent of
whatever else the loop runs meanwhile).

Records go into one ring of fixed size, the oldest overwritten when it is
full; ``drain()`` returns them in order of start with the number
overwritten (``dropped``) and clears the ring.  Nothing is written out
before ``drain()``.

One clock with the device trace: a ``torch.profiler`` Chrome trace gives
its events' ``ts`` in microseconds after ``baseTimeNanoseconds`` on the
Unix clock.  ``Anchor()`` pairs ``perf_counter_ns`` with the Unix clock
once, so ``anchor.trace_us(ns, base_ns)`` puts a span's times on the
trace's time line; ``chrome_events`` writes records as ``X`` events there.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

RING = 1 << 17          # records kept between drains
SPAN_CATEGORY = "host_span"   # the Chrome-trace category of the spans


class Record(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    key: Optional[float]
    tid: int
    start_ns: int
    end_ns: int
    counts: Dict[str, object]
    ident: int


class Records(list):
    """``drain()``'s records, with ``dropped``: how many the ring lost."""

    dropped = 0


class _NoSpan:
    """The one context ``span`` returns while the recorder is off."""

    __slots__ = ()
    id = None
    key = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


class _Recorder:
    """The process's recorder: a flag, the ring and the span numbers."""

    def __init__(self, size: int = RING):
        self.on = False
        self.size = size
        self.ring: List[Optional[tuple]] = [None] * size
        # ``next`` on an itertools.count is atomic under the interpreter
        # lock, so threads take ring slots and span ids without a lock.
        self.written = itertools.count()
        self.ids = itertools.count(1)
        self.local = threading.local()

    def thread(self):
        """This thread's (stack of open spans, native id, pthread id)."""
        try:
            return self.local.thread
        except AttributeError:
            self.local.thread = ([], threading.get_native_id(),
                                 threading.get_ident())
            return self.local.thread

    def put(self, rec: tuple) -> None:
        self.ring[next(self.written) % self.size] = rec

    def drain(self) -> Records:
        n = next(self.written)   # one past the last slot taken
        ring, self.ring = self.ring, [None] * self.size
        self.written = itertools.count()
        out = Records(Record(*r) for r in ring if r is not None)
        out.sort(key=lambda r: (r.start_ns, r.id))
        out.dropped = max(0, n - self.size)
        return out


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "id", "parent", "key", "counts", "start_ns")

    def __init__(self, name, parent, key, counts):
        self.name = name
        self.parent = parent
        self.key = key
        self.counts = counts

    def __enter__(self):
        stack = _REC.thread()[0]
        parent = self.parent
        if parent is None and stack:
            parent = stack[-1]
        if parent is not None:
            if self.key is None:
                self.key = parent.key
            parent = parent.id
        self.parent = parent
        self.id = next(_REC.ids)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack, tid, ident = _REC.thread()
        stack.pop()
        _REC.put((self.name, self.id, self.parent, self.key, tid,
                  self.start_ns, end, self.counts, ident))
        return False


def span(name: str, parent=None, key=None, **counts):
    """A span named ``name`` (a context manager); ``parent`` is an open
    span on another thread, ``key`` the packet or word."""
    if not _REC.on:
        return NOOP
    return _Span(name, parent, key, counts)


def enabled() -> bool:
    return _REC.on


def enable() -> None:
    _REC.on = True


def disable() -> None:
    _REC.on = False


def now() -> Optional[int]:
    """``perf_counter_ns()`` while the recorder is on, else None."""
    return time.perf_counter_ns() if _REC.on else None


def record(name: str, start_ns: Optional[int], key=None, **counts) -> None:
    """Close a span that began at ``start_ns`` (from ``now()``) on this
    thread now; nothing when the recorder is off or the start is None."""
    if not _REC.on or start_ns is None:
        return
    _, tid, ident = _REC.thread()
    _REC.put((name, next(_REC.ids), None, key, tid, start_ns,
              time.perf_counter_ns(), counts, ident))


def drain() -> Records:
    """Every record since the last drain, in order of start; the ring is
    cleared.  ``.dropped`` counts the records the full ring overwrote."""
    return _REC.drain()


class Anchor:
    """One reading of ``perf_counter_ns`` and the Unix clock together: the
    Unix reading is bracketed by two ``perf_counter_ns`` reads, and the
    pair is their midpoint (``spread_ns``: the bracket's width)."""

    def __init__(self):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        self.perf_ns = (a + b) // 2
        self.unix_ns = unix
        self.spread_ns = b - a

    def unix(self, perf_ns: int) -> int:
        return perf_ns - self.perf_ns + self.unix_ns

    def trace_us(self, perf_ns: int, base_ns: int) -> float:
        """``perf_ns`` as a Chrome trace's ``ts``: microseconds after the
        trace's ``baseTimeNanoseconds``."""
        return (self.unix(perf_ns) - base_ns) / 1e3


def trace_thread(ident: int) -> int:
    """A pthread id as a trace of CUDA activity alone names the thread
    (torch 2.11's profiler): its low 32 bits as a signed number, made
    positive."""
    low = ident & 0xFFFFFFFF
    return abs(low - (1 << 32)) if low >> 31 else low


def chrome_events(records, anchor: Anchor, base_ns: int,
                  pid: int) -> List[dict]:
    """Records as Chrome-trace ``X`` events on the trace's clock, category
    ``SPAN_CATEGORY``, on the row of the thread that ran them (its native
    id; ``args["ident"]``: ``trace_thread`` of its pthread id, as a trace
    of CUDA activity alone names the thread of a launch call)."""
    out = []
    for r in records:
        ts = anchor.trace_us(r.start_ns, base_ns)
        args = dict(r.counts, id=r.id, ident=trace_thread(r.ident))
        if r.parent is not None:
            args["parent"] = r.parent
        if r.key is not None:
            args["key"] = r.key
        out.append(dict(ph="X", cat=SPAN_CATEGORY, name=r.name, pid=pid,
                        tid=r.tid, ts=ts, dur=(r.end_ns - r.start_ns) / 1e3,
                        args=args))
    return out
