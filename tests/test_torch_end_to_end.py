"""The port's closed loop over real ZMQ sockets, on the CPU: the port's
replay amplifier (dss_tpu_torch.apps.development_amplifier) publishes a
synthetic BCI2000 session on port 5897 and the port's app
(dss_tpu_torch.apps.decode_online, ``--device cpu``) decodes it with a
threshold-VAD LSTM checkpoint through the fused and through the separate
packet path.  The burst must come out as a wav plus the logs, as in
tests/test_end_to_end.py for the JAX app.  Also: the port's packet codec
against the JAX package's native one, byte for byte."""

import configparser
import contextlib
import logging
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import savemat
from scipy.io.wavfile import read as wavread

from dss_tpu.native import pack_packet as jax_pack_packet
from dss_tpu.native import unpack_packet as jax_unpack_packet
from dss_tpu_torch.apps import decode_online
from dss_tpu_torch.apps.development_amplifier import Amplifier
from dss_tpu_torch.runtime.units import interpret_bci2000_packet, \
    pack_packet

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from torch_make_verify_fixtures import threshold_vad  # noqa: E402

# 5899 and 5898 belong to test_end_to_end.py and test_multichip_graph.py.
PORT = 5897


def _make_session_mat(path, fs=1000, seconds=6.0, burst=(2.0, 3.5)):
    """tests/test_end_to_end.py's session: 129 channels of noise with one
    loud burst (independent per channel, so CAR keeps the power)."""
    rng = np.random.default_rng(7)
    T = int(seconds * fs)
    envelope = np.full(T, 0.05)
    envelope[int(burst[0] * fs):int(burst[1] * fs)] = 2.0
    signal = rng.normal(size=(T, 129)) * envelope[:, None]
    code = np.zeros(T, np.int16)
    code[int(burst[0] * fs):int(burst[1] * fs)] = 1
    savemat(str(path), {
        "signal": signal,
        "parameters": {
            "SamplingRate": {"NumericValue": fs},
            "SourceChGain": {"NumericValue": np.ones(129)},
            "Stimuli": {"Value": np.array([["Enter"]])},
        },
        "states": {"StimulusCode": code},
    })
    return signal


def _threshold_vad(path):
    """tools/torch_make_verify_fixtures.py's threshold VAD (speech iff
    mean(feature) > -2.5) as a 2 x 150 LSTM checkpoint file."""
    np.savez(path, **threshold_vad())
    return path


@pytest.mark.parametrize("shape", [(40, 129), (1, 1), (320, 64)])
def test_packet_codec_matches_the_jax_package(shape):
    """pack_packet is byte-identical to dss_tpu.native.pack_packet, and the
    port's decoder gives dss_tpu.native.unpack_packet's array exactly."""
    data = np.random.default_rng(shape[0]).normal(size=shape).astype(
        np.float32)
    packet = pack_packet(data)
    assert packet == jax_pack_packet(data)
    got = interpret_bci2000_packet(packet)
    want = jax_unpack_packet(packet)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data.astype(np.float64))


def _wait_until_read(raw_log, quiet=1.0, timeout=120.0):
    """Return once the app's raw log has not grown for ``quiet`` seconds:
    the decoder has read every packet of the session so far.  On a loaded
    CPU the eager packet path runs slower than real time; a publisher
    restarted while packets still sit in the old connection's socket
    buffers would find the subscriber not yet reconnected and send its
    whole session to no one."""
    last, still_since = -1, time.monotonic()
    deadline = still_since + timeout
    while time.monotonic() < deadline:
        size = raw_log.stat().st_size if raw_log.exists() else 0
        if size != last:
            last, still_since = size, time.monotonic()
        elif time.monotonic() - still_since >= quiet:
            return
        time.sleep(0.05)


@pytest.mark.parametrize("fused_frontend", [True, False])
def test_closed_loop_over_zmq(tmp_path, fused_frontend):
    """Two replays of a 6 s session (one burst at 2.0-3.5 s each) through
    one run of the app, as the JAX test streams them (the amplifier
    restarts, once the app has read the first, and the decoder keeps
    segmenting).  Every log is written in
    the JAX app's layout and every segment's wav holds its frames x 160
    int16 samples, which also went to stdout."""
    mat = tmp_path / "KeywordSynthesis_Overt_R01.mat"
    signal = _make_session_mat(mat)
    cfg = configparser.ConfigParser()
    cfg.read(REPO / "config" / "debug_settings.ini")
    for key, value in dict(
            base_out_dir=str(tmp_path), address="127.0.0.1", port=str(PORT),
            fs="1000", package_size="40", idle_timeout="8.0",
            vad_model_weights=str(_threshold_vad(tmp_path / "vad.npz")),
            vocoder_backend="dsp", fused_frontend=str(fused_frontend),
            fused_decoder="false", segment_prewarm_frames="[100]").items():
        cfg.set("Decoding", key, value)
    ini = tmp_path / "cfg.ini"
    with open(ini, "w") as fd:
        cfg.write(fd)

    # Gate the amplifier on the graph's readiness, not on a fixed sleep:
    # on a loaded machine the units' warm-ups can outlast the first burst.
    ready = threading.Event()

    class Ready(logging.Handler):
        def emit(self, record):
            if "starting sources" in record.getMessage():
                ready.set()

    graph_log = logging.getLogger("dss_tpu_torch.runtime")
    handler, level = Ready(), graph_log.level
    graph_log.addHandler(handler)
    graph_log.setLevel(logging.INFO)

    def amplifiers():
        if not ready.wait(timeout=300):
            return
        for k in range(2):
            if k:
                _wait_until_read(tmp_path / "run" / "log.raw.f64")
            # epsilon=5ms: a 100ns spin-wait would starve the decoder on a
            # one-core machine and drop packets.
            amp = Amplifier(mat_file=str(mat), package_size=40, port=PORT,
                            epsilon=0.005)
            try:
                amp.stream()
            finally:
                amp.close()

    amp_thread = threading.Thread(target=amplifiers, daemon=True)
    amp_thread.start()
    try:
        with open(tmp_path / "audio.pcm", "w") as fd, \
                contextlib.redirect_stdout(fd):
            decode_online.main([str(ini), "--run", "run", "--device",
                                "cpu"])
    finally:
        graph_log.removeHandler(handler)
        graph_log.setLevel(level)
        ready.set()
    amp_thread.join(timeout=30)
    assert not amp_thread.is_alive()

    run = tmp_path / "run"
    raw = np.fromfile(run / "log.raw.f64", np.float64).reshape(-1, 129)
    assert len(raw) >= 5000  # ~6 s at 1 kHz (drop-old may lose a few)
    # Packets arrive whole and in order: each logged packet is one of the
    # session's, as the amplifier sent it (float32 on the wire).
    sent = signal.astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(raw[-40:], sent[-40:])
    hga = np.fromfile(run / "log.hga.f64", np.float64).reshape(-1, 64)
    assert len(hga) >= len(raw) // 10 - 10
    rows = (run / "log.vad.lab").read_text().strip().split("\n")
    assert len(rows) >= 2, rows
    assert all(r.split("\t")[2].endswith("frames") for r in rows)
    spans = [(float(s), float(e)) for s, e, _ in
             (r.split("\t") for r in rows)]
    assert any(1.0 <= s <= 3.0 and e - s >= 1.0 for s, e in spans), spans
    lpc = np.fromfile(run / "log.lpc.f32", np.float32).reshape(-1, 20)
    assert len(lpc) >= 100 and np.all(np.isfinite(lpc))
    total = 0
    for i in range(len(rows)):
        fs, pcm = wavread(str(run / "reco" / f"reco_{i + 1:05d}.wav"))
        assert fs == 16000 and pcm.dtype == np.int16
        total += len(pcm)
    assert total == len(lpc) * 160
    stdout_pcm = np.fromfile(tmp_path / "audio.pcm", np.int16)
    assert len(stdout_pcm) == total
