"""The port's multi-stream word unit one level up, on the CPU: the
counterpart of tests/test_multichip_graph.py.  The closed-loop graph of
the port's app (replay amplifier over real ZMQ on port 5896 -> ingest ->
fused front end + nVAD -> segment close -> word path) runs with
``ShardedFusedDecoderVocoder`` at 8 streams in place of the single-stream
word unit: the same INPUT / LPC / OUTPUT / WORD surface, so the app's
wiring is untouched, and the logs and audio keep their contracts.  Also
the port's ``serve_multichip`` on two spawned gloo ranks, whose JSON line
carries the JAX app's keys."""

import contextlib
import json
import logging
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import torch
from scipy.io.wavfile import read as wavread

from dss_tpu_torch.apps import decode_online
from dss_tpu_torch.apps.development_amplifier import Amplifier
from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
from dss_tpu_torch.runtime.units import ShardedFusedDecoderVocoder, \
    ShardedFusedDecoderVocoderSettings, ZMQConnectorSettings
from dss_tpu_torch.vocoder import net as tnet

from test_torch_end_to_end import _make_session_mat, _threshold_vad

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
# 5899, 5898 and 5897 belong to the other end-to-end tests.
PORT = 5896
JAX_KEYS = {"devices", "streams", "frames_per_step", "dispatch_seconds",
            "step_seconds_device", "aggregate_frames_per_s",
            "realtime_factor", "pcm_shape"}


def _small_voc_npz(path):
    """A small vocoder (GRU-A 64, GRU-B 16, cond 32, embed 16), seeded."""
    m = tnet.LPCNetModel(gru_a_units=64, gru_b_units=16, cond_dim=32,
                         embed_dim=16)
    p = m.init(torch.Generator().manual_seed(2), "cpu")
    np.savez(path, **{k: v.numpy() for k, v in p.items()})
    return str(path)


def test_closed_loop_graph_with_sharded_word_path(tmp_path):
    mat = tmp_path / "KeywordSynthesis_Overt_R01.mat"
    _make_session_mat(mat)
    voc_w = _small_voc_npz(tmp_path / "voc_small.npz")
    run_dir = tmp_path / "run"
    run_dir.mkdir()

    class ShardedNeuroprosthesis(decode_online.Neuroprosthesis):
        DECODE_VOCODE = ShardedFusedDecoderVocoder()

        def configure_source(self):
            self.CONNECTOR.apply_settings(ZMQConnectorSettings(
                fs=1000, address="127.0.0.1", port=PORT, idle_timeout=8.0))

        def configure(self):
            super().configure()
            self.DECODE_VOCODE.apply_settings(
                ShardedFusedDecoderVocoderSettings(
                    path_to_model_weights=None,
                    model=BidirectionalSpeechSynthesisModel,
                    params=dict(nb_layer=1, nb_hidden_units=16,
                                nb_electrodes=64),
                    vocoder_weights=voc_w, length_multiple=50,
                    streams=8, device="cpu"))

    system = ShardedNeuroprosthesis(decode_online.NeuroprosthesisSettings(
        destination_dir=str(run_dir), address="127.0.0.1", fs=1000,
        package_size=40, idle_timeout=8.0,
        vad_model_weights=_threshold_vad(tmp_path / "vad.npz"),
        vocoder_backend="net", vocoder_weights=voc_w, fused_frontend=True,
        fused_decoder=True, segment_prewarm_frames=(), device="cpu"))

    # Start the amplifier once the graph is up (its units' set-up can
    # outlast a fixed sleep on a loaded machine).
    ready = threading.Event()

    class Ready(logging.Handler):
        def emit(self, record):
            if "starting sources" in record.getMessage():
                ready.set()

    graph_log = logging.getLogger("dss_tpu_torch.runtime")
    handler, level = Ready(), graph_log.level
    graph_log.addHandler(handler)
    graph_log.setLevel(logging.INFO)

    def run_amplifier():
        if not ready.wait(timeout=300):
            return
        amp = Amplifier(mat_file=str(mat), package_size=40, port=PORT,
                        epsilon=0.005)
        try:
            amp.stream()
        finally:
            amp.close()

    amp_thread = threading.Thread(target=run_amplifier, daemon=True)
    amp_thread.start()
    try:
        with open(tmp_path / "audio.pcm", "w") as fd, \
                contextlib.redirect_stdout(fd):
            decode_online.ez.run_system(system)
    finally:
        graph_log.removeHandler(handler)
        graph_log.setLevel(level)
        ready.set()
    amp_thread.join(timeout=30)
    assert not amp_thread.is_alive()

    unit = system.DECODE_VOCODE
    assert isinstance(unit, ShardedFusedDecoderVocoder)
    assert unit._streams == 8 and unit._world == 1
    # The burst was segmented, decoded and vocoded through the graph, and
    # every serve slot shipped audio of the live word's length (no feeder:
    # every slot replays the live segment).
    vad_lines = (run_dir / "log.vad.lab").read_text().strip().split("\n")
    assert len(vad_lines) >= 1, vad_lines
    lpc = np.fromfile(run_dir / "log.lpc.f32", np.float32).reshape(-1, 20)
    assert len(lpc) >= 100 and np.all(np.isfinite(lpc))
    fs, pcm = wavread(str(run_dir / "reco" / "reco_00001.wav"))
    assert fs == 16000 and pcm.dtype == np.int16
    assert sorted(unit.slot_audio) == list(range(1, 8))
    assert all(len(a) == len(pcm) for a in unit.slot_audio.values())
    # Audio accounting: the wav tap carries whole words (160 samples a
    # decoded frame over the segmented spans) and stdout the same bytes.
    n_seg_frames = sum(int(line.split("\t")[2].split()[0].strip('"'))
                       for line in vad_lines)
    total_wav = sum(
        len(wavread(str(run_dir / "reco" / f"reco_{i + 1:05d}.wav"))[1])
        for i in range(len(vad_lines)))
    assert total_wav == n_seg_frames * 160 == len(lpc) * 160
    assert len(np.fromfile(tmp_path / "audio.pcm", np.int16)) == total_wav


def test_serve_multichip_on_two_gloo_ranks(tmp_path):
    """``serve_multichip --devices 2 --device cpu`` spawns two gloo ranks
    and prints the JAX app's JSON line (its keys, every stream's audio)."""
    voc_w = _small_voc_npz(tmp_path / "voc_small.npz")
    out = subprocess.run(
        [sys.executable, "-m", "dss_tpu_torch.apps.serve_multichip",
         "--devices", "2", "--device", "cpu", "--streams-per-device", "2",
         "--frames", "2", "--steps", "2", "--weights", voc_w],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) == JAX_KEYS
    assert line["devices"] == 2 and line["streams"] == 4
    assert line["frames_per_step"] == 2 and line["pcm_shape"] == [4, 320]
    assert line["step_seconds_device"] > 0 and line["realtime_factor"] > 0
