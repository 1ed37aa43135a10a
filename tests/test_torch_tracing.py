"""The port's span recorder (dss_tpu_torch/utils/tracing.py) on the CPU:
off it hands out one shared no-op and records nothing; on it nests spans
by thread, takes a parent across an executor hop, counts what its ring
overwrote, and maps spans onto a torch.profiler trace's clock.  A CPU
session of the app's graph (threshold nVAD, a few dozen packets, two
words) leaves the spans each packet and word should have, nested, and
timing what the units' own lists time."""

import contextlib
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from dss_tpu_torch.apps import decode_online
from dss_tpu_torch.runtime import run_system
from dss_tpu_torch.runtime import units as tunits
from dss_tpu_torch.utils import tracing
from dss_tpu_torch.utils.profiling import device_trace, trace_files

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def recorder():
    """The recorder on, emptied before and after; off again after."""
    tracing.drain()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


def test_span_off_is_the_shared_noop():
    tracing.disable()
    tracing.drain()
    sp = tracing.span("units.fe_call", packets=2)
    assert sp is tracing.NOOP
    with sp as inner:
        assert inner is tracing.NOOP and inner.id is None
    assert tracing.now() is None
    tracing.record("graph.wait", 0, place=0)
    assert tracing.drain() == []


def test_spans_nest_on_one_thread(recorder):
    with tracing.span("outer", key=7.5, packets=3) as outer:
        with tracing.span("inner", frames=40):
            pass
        with tracing.span("other", key=2.0):
            pass
    recs = {r.name: r for r in tracing.drain()}
    assert set(recs) == {"outer", "inner", "other"}
    assert recs["outer"].parent is None and recs["outer"].key == 7.5
    assert recs["outer"].counts == {"packets": 3}
    assert recs["inner"].parent == outer.id and recs["inner"].key == 7.5
    assert recs["inner"].counts == {"frames": 40}
    assert recs["other"].parent == outer.id and recs["other"].key == 2.0
    assert recs["inner"].tid == threading.get_native_id()
    assert recs["inner"].ident == threading.get_ident()
    for name in ("inner", "other"):
        assert recs["outer"].start_ns <= recs[name].start_ns \
            <= recs[name].end_ns <= recs["outer"].end_ns


def test_parent_passes_across_an_executor_hop(recorder):
    """A span on a worker thread takes the span handed to it as parent
    (and its key); the worker's own stack stays its own."""
    pool = ThreadPoolExecutor(max_workers=1)

    def work(parent):
        with tracing.span("hop", parent=parent):
            with tracing.span("below"):
                pass
        with tracing.span("alone"):
            pass
        return threading.get_native_id()

    try:
        with tracing.span("loop", key=3.0) as outer:
            worker = pool.submit(work, outer).result(timeout=30)
    finally:
        pool.shutdown()
    recs = {r.name: r for r in tracing.drain()}
    assert recs["hop"].parent == outer.id and recs["hop"].key == 3.0
    assert recs["hop"].tid == worker != recs["loop"].tid
    assert recs["below"].parent == recs["hop"].id
    assert recs["below"].key == 3.0
    assert recs["alone"].parent is None and recs["alone"].key is None


def test_ring_overflow_is_counted(recorder, monkeypatch):
    monkeypatch.setattr(tracing, "_REC", tracing._Recorder(size=8))
    tracing.enable()
    for i in range(20):
        with tracing.span("s", i=i):
            pass
    recs = tracing.drain()
    assert recs.dropped == 12
    assert [r.counts["i"] for r in recs] == list(range(12, 20))
    assert tracing.drain().dropped == 0


def test_trace_thread_names_threads_as_a_cuda_trace_does():
    """A trace of CUDA activity alone (torch 2.11 on the card) named two
    threads whose pthread ids were 0x7ffb16607300 and 0x7ff7c77ff6c0 as
    375419648 and 947915072: the low 32 bits, signed, made positive."""
    assert tracing.trace_thread(0x7FFB16607300) == 375419648
    assert tracing.trace_thread(0x7FF7C77FF6C0) == 947915072
    assert tracing.trace_thread(0x12345678) == 0x12345678


def test_record_closes_a_span_begun_earlier(recorder):
    t0 = tracing.now()
    tracing.record("graph.wait", t0, key=1.5, place=2, edge="U.INPUT")
    tracing.record("graph.wait", None, key=9.0)   # begun while off
    (r,) = tracing.drain()
    assert r.name == "graph.wait" and r.key == 1.5 and r.parent is None
    assert r.counts == {"place": 2, "edge": "U.INPUT"}
    assert t0 == r.start_ns <= r.end_ns


def test_spans_land_on_the_profiler_clock(tmp_path):
    """Under ``device_trace`` on the CPU, a span around a ``torch.mm``,
    written into the trace on its clock, holds that op's event to within
    1 ms; the spans sit on their thread's row."""
    a = torch.randn(256, 256)
    with device_trace(str(tmp_path), device="cpu"):
        with tracing.span("around_mm"):
            torch.mm(a, a)
    assert not tracing.enabled()
    (path,) = trace_files(str(tmp_path))
    events = json.load(open(path))["traceEvents"]
    (sp,) = [e for e in events if e.get("cat") == tracing.SPAN_CATEGORY]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert sp["name"] == "around_mm" and sp["ph"] == "X"
    assert sp["tid"] == mm["tid"] == threading.get_native_id()
    assert sp["ts"] - 1000.0 <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"] + 1000.0


def _two_word_session(seconds=4.8, fs=1000, bursts=((0.8, 1.3), (2.2, 2.7))):
    rng = np.random.default_rng(11)
    envelope = np.full(int(seconds * fs), 0.05)
    for a, b in bursts:
        envelope[int(a * fs):int(b * fs)] = 2.0
    return rng.normal(size=(len(envelope), 129)) * envelope[:, None]


def _ini(tmp_path, **keys):
    import sys
    sys.path.insert(0, str(REPO / "tools"))
    from torch_make_verify_fixtures import threshold_vad

    vad = tmp_path / "vad.npz"
    np.savez(vad, **threshold_vad())
    keys = dict(base_out_dir=tmp_path, vad_model_weights=vad,
                segment_prewarm_frames="[100]", **keys)
    lines = []
    for line in (REPO / "config" / "debug_settings.ini").read_text(
            ).splitlines():
        key = line.split("=")[0].strip()
        if key in keys:
            line = f"{key} = {keys[key]}"
        lines.append(line)
    ini = tmp_path / "cfg.ini"
    ini.write_text("\n".join(lines) + "\n")
    return ini


def _inside(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def _close(spans_ms, unit_ms):
    return abs(sum(spans_ms) - sum(unit_ms)) <= 0.05 * sum(unit_ms)


@pytest.mark.parametrize("fused_decoder", [True, False])
def test_session_spans(tmp_path, recorder, fused_decoder):
    """The fused packet path with the fused word path or the separate
    chain, both on the DSP vocoder, replayed on the CPU: every packet has
    its wait on the packet path's edge and a packet call; every word its
    decode under its head (or decode) span, one word id; every child lies
    inside its parent; and the spans time what step_ms, word_ms (or
    decode_ms and vocode_ms) time, within 5% in total."""
    raw = _two_word_session()
    ini = _ini(tmp_path, fused_frontend="true",
               fused_decoder=str(fused_decoder).lower())
    s = decode_online.build_settings(str(ini), "run", device="cpu")

    class Replayed(decode_online.Neuroprosthesis):
        CONNECTOR = tunits.PacketReplay()

        def configure_source(self):
            self.CONNECTOR.apply_settings(tunits.PacketReplaySettings(
                data=raw, fs=1000))

    system = Replayed(s)
    with open(tmp_path / "audio.pcm", "w") as fd, \
            contextlib.redirect_stdout(fd):
        run_system(system)
    recs = tracing.drain()
    assert recs.dropped == 0
    by_id = {r.id: r for r in recs}
    named = {}
    for r in recs:
        named.setdefault(r.name, []).append(r)

    # Packets: one wait on the packet path's edge each, and the call
    # carrying it starts after the packet was taken.
    n_packets = len(raw) // 40
    waits = sorted((r for r in named["graph.wait"]
                    if r.counts["edge"] == "FusedFrontendVad.INPUT"),
                   key=lambda r: r.key)
    assert len(waits) == n_packets
    assert len({w.key for w in waits}) == n_packets
    calls = sorted(named["units.fe_call"], key=lambda r: r.start_ns)
    assert sum(c.counts["packets"] for c in calls) == n_packets
    i = 0
    for c in calls:
        carried = waits[i:i + c.counts["packets"]]
        assert carried[0].key == c.key
        assert all(w.end_ns <= c.start_ns for w in carried)
        i += c.counts["packets"]
    for name in ("units.fe_h2d", "units.fe_launch", "units.fe_read"):
        assert {by_id[r.parent].name for r in named[name]} == \
            {"units.fe_call"}
        assert len(named[name]) == len(calls)
    assert len(named["units.fe_segment"]) == len(calls)

    # Words: a decode inside each head under the word's id.
    unit = system.DECODE_VOCODE if fused_decoder else system.DECODING_MODEL
    n_words = len(unit.word_ms if fused_decoder else unit.decode_ms)
    assert n_words >= 2
    head = "units.word_head" if fused_decoder else "units.decode"
    heads = named[head]
    assert len(heads) == n_words and len({h.key for h in heads}) == n_words
    for h in heads:
        kids = [r for r in recs if r.parent == h.id]
        assert [k.name for k in kids if k.name == "models.decode"] == \
            ["models.decode"]
        assert all(k.key == h.key for k in kids)
        if fused_decoder:
            assert {k.name for k in kids} == {"models.decode", "vocoder.dsp",
                                             "units.word_read"}
    if not fused_decoder:
        vocodes = named["units.vocode"]
        assert sorted(v.key for v in vocodes) == sorted(h.key for h in heads)
        assert all(by_id[r.parent].name == "units.vocode"
                   for r in named["vocoder.dsp"] if r.parent is not None)
    decodes = [r for r in named["models.decode"] if r.parent is not None]
    assert all(r.counts["padded_frames"] % 50 == 0
               and 0 < r.counts["frames"] <= r.counts["padded_frames"]
               for r in decodes)

    for r in recs:
        if r.parent is not None:
            assert _inside(r, by_id[r.parent]), (r, by_id[r.parent])

    def ms(name):
        return [(r.end_ns - r.start_ns) / 1e6 for r in named[name]]

    assert _close(ms("units.fe_call"), system.FUSED_FRONTEND.step_ms)
    if fused_decoder:
        assert _close(ms("units.word_head"), unit.word_ms)
    else:
        assert _close(ms("units.decode"), unit.decode_ms)
        assert _close(ms("units.vocode"),
                      system.WAVEFORM_GENERATOR.vocode_ms)
