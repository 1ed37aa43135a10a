"""The port's device trace (dss_tpu_torch/utils/profiling.py) on the CPU:
``device_trace`` on torch.profiler (a Chrome trace naming the ops of the
caller's thread and of an executor thread), and the app's
``--profile-dir`` (the units' ops and host spans in one trace)."""

import contextlib
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from dss_tpu_torch.apps import decode_online
from dss_tpu_torch.runtime import units as tunits
from dss_tpu_torch.utils import tracing
from dss_tpu_torch.utils.profiling import device_trace, trace_files, \
    trace_summary

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def test_device_trace_records_every_thread(tmp_path):
    """On the CPU the trace is a Chrome trace that names the ops of the
    caller's thread and of a one-worker executor's (the units' device
    calls run on such threads); it holds no kernel."""
    executor = ThreadPoolExecutor(max_workers=1)
    worker = executor.submit(threading.get_native_id).result()

    def work():
        a = torch.randn(32, 32)
        return (a @ a).sum()

    with device_trace(str(tmp_path), device="cpu"):
        torch.ones(4).mul(3)
        executor.submit(work).result()
    executor.shutdown()
    (path,) = trace_files(str(tmp_path))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mul" in names and "aten::mm" in names
    s = trace_summary(path)
    assert s["kernels"] == 0 and s["busy_us"] == 0.0
    assert s["threads"][worker]["cpu_ops"] >= 2
    assert s["threads"][threading.get_native_id()]["cpu_ops"] >= 1


def test_device_trace_defaults_to_the_card():
    """Like every entry point, ``device_trace`` runs on cuda unless asked
    otherwise, and raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with device_trace("unused"):
            pass


def test_app_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    """``decode_online --profile-dir`` wraps the run in ``device_trace``: a
    3 s session replayed in-process through the shipped INI on the CPU
    (the separate chain) leaves one trace with the units' ops, run on
    their executor threads, and their host spans on the trace's clock,
    beside the run's logs."""
    from test_torch_end_to_end import _threshold_vad

    fs = 1000
    rng = np.random.default_rng(7)
    envelope = np.full(3 * fs, 0.05)
    envelope[1000:1400] = 2.0
    raw = rng.normal(size=(3 * fs, 129)) * envelope[:, None]

    class Replayed(decode_online.Neuroprosthesis):
        CONNECTOR = tunits.PacketReplay()

        def configure_source(self):
            self.CONNECTOR.apply_settings(tunits.PacketReplaySettings(
                data=raw, fs=fs))

    monkeypatch.setattr(decode_online, "Neuroprosthesis", Replayed)
    ini = tmp_path / "cfg.ini"
    text = (REPO / "config" / "debug_settings.ini").read_text()
    lines = []
    for line in text.splitlines():
        key = line.split("=")[0].strip()
        if key == "base_out_dir":
            line = f"base_out_dir = {tmp_path}"
        elif key == "vad_model_weights":
            line = f"vad_model_weights = {_threshold_vad(tmp_path / 'v.npz')}"
        elif key == "segment_prewarm_frames":
            line = "segment_prewarm_frames = [100]"
        lines.append(line)
    ini.write_text("\n".join(lines) + "\n")
    prof = tmp_path / "profile"
    with open(tmp_path / "audio.pcm", "w") as fd, \
            contextlib.redirect_stdout(fd):
        decode_online.main([str(ini), "--run", "run", "--device", "cpu",
                            "--profile-dir", str(prof)])
    (path,) = trace_files(str(prof))
    s = trace_summary(path)
    assert (tmp_path / "run" / "log.hga.f64").stat().st_size > 0
    # The front end's and the VAD's device calls run on their executors.
    ops = {tid: t["cpu_ops"] for tid, t in s["threads"].items()}
    assert sum(n > 0 for n in ops.values()) >= 3, ops
    assert sum(ops.values()) > 1000
    # The host spans: every packet's waits, the word's decode and vocode.
    assert s["spans"]["graph.wait"] >= 2 * 75
    for name in ("units.decode", "models.decode", "units.vocode",
                 "vocoder.dsp"):
        assert s["spans"].get(name, 0) >= 1, s["spans"]
    assert not tracing.enabled()
    events = json.load(open(path))["traceEvents"]
    spans = [e for e in events if e.get("cat") == tracing.SPAN_CATEGORY]
    (trace,) = [e for e in events if e.get("cat") == "Trace"] or [None]
    if trace is not None:   # spans lie inside the profiler's own span
        assert all(trace["ts"] <= e["ts"] <= e["ts"] + e["dur"]
                   <= trace["ts"] + trace["dur"] for e in spans)
    # A word's spans run on the decoder's and vocoder's executor threads,
    # the rows their ops are on.
    word = [e for e in spans if e["name"] in ("units.decode",
                                              "units.vocode")]
    assert all(ops.get(e["tid"], 0) > 0 for e in word)
