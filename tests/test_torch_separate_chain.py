"""The separate-chain units of the port against their JAX twins, on the CPU,
and the shipped configuration's graph.

* ``HighGammaActivity`` and ``FilterSpeechSegments`` on the synthetic
  session of tools/make_verify_fixtures.py with its threshold VAD;
* ``RecurrentNeuralDecodingModel`` on a padded segment with the same
  checkpoint file;
* ``DelayedLPCNetVocoder`` (dsp) over two words with the JAX vocoder's own
  noise injected into the port's, and the port's ``FusedDecoderVocoder``
  (dsp) against the port's separate chain at equal padding;
* ``DelayedStdoutForSoX``'s latency budget, the bucket policy and
  ``segment_policy_labs``;
* ``Neuroprosthesis`` from the shipped INI on the CPU (the fully separate
  chain, dsp vocoder) with an in-process replay: every log file in the
  JAX app's format.
"""

import asyncio
import configparser
import contextlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dss_tpu.runtime.messages as jmessages
import dss_tpu.runtime.units as junits
from dss_tpu.models import BidirectionalSpeechSynthesisModel as JDec
from dss_tpu.models import UnidirectionalVoiceActivityDetector as JVad
from dss_tpu.ops import CommonAverageReferencing as JCAR
from dss_tpu.ops import ZScoreNormalization as JZ
from dss_tpu.runtime import bucket_policy as jpolicy
from dss_tpu.utils import channels as jch
from dss_tpu_torch.apps.decode_online import Neuroprosthesis, build_settings, \
    feature_transforms
from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
from dss_tpu_torch.models.lstm import seeded_init
from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector
from dss_tpu_torch.ops import dsp_synthesis as tdsp_ops
from dss_tpu_torch.runtime import ClosedLoopMessage
from dss_tpu_torch.runtime import bucket_policy as tpolicy
from dss_tpu_torch.runtime import run_system
from dss_tpu_torch.runtime import units as tunits
from dss_tpu_torch.vocoder import dsp as tdsp

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
DEBUG_INI = REPO / "config" / "debug_settings.ini"


def _session(seconds=6.0, burst=(2.0, 3.5)):
    """tools/make_verify_fixtures.py's session: noise, one loud burst."""
    fs = 1000
    rng = np.random.default_rng(7)
    T = int(seconds * fs)
    envelope = np.full(T, 0.05)
    envelope[int(burst[0] * fs):int(burst[1] * fs)] = 2.0
    return rng.normal(size=(T, 129)) * envelope[:, None]


def _threshold_vad(path):
    """tools/make_verify_fixtures.py's threshold VAD (speech iff
    mean(feature) > -2.5) as a 2 x 150 LSTM checkpoint file."""
    H, IN, s, theta = 150, 64, 10.0, -2.5
    sd = {}
    for layer, in_size in ((0, IN), (1, H)):
        w_ih = np.zeros((4 * H, in_size), np.float32)
        b_ih = np.zeros(4 * H, np.float32)
        b_ih[0:H], b_ih[H:2 * H], b_ih[3 * H:] = 10.0, -10.0, 10.0
        if layer == 0:
            w_ih[2 * H, :] = s / IN
            b_ih[2 * H] = -s * theta
        else:
            w_ih[2 * H, 0] = s
        sd[f"lstm.weight_ih_l{layer}"] = w_ih
        sd[f"lstm.weight_hh_l{layer}"] = np.zeros((4 * H, H), np.float32)
        sd[f"lstm.bias_ih_l{layer}"] = b_ih
        sd[f"lstm.bias_hh_l{layer}"] = np.zeros(4 * H, np.float32)
    cls_w = np.zeros((2, H), np.float32)
    cls_w[0, 0], cls_w[1, 0] = -5.0, 5.0
    sd["classifier.weight"] = cls_w
    sd["classifier.bias"] = np.zeros(2, np.float32)
    np.savez(path, **sd)
    return path


def _decoder_npz(path, hidden=16, electrodes=64):
    """A seeded 2-layer bidirectional decoder checkpoint in torch layout."""
    model = BidirectionalSpeechSynthesisModel(2, hidden, electrodes)
    seeded_init(model, 3)
    np.savez(path, **{k: v.numpy() for k, v in model.state_dict().items()})
    return path


def _jax_transforms():
    sel = jch.SelectElectrodesOverSpeechAreas()
    pre = [jch.SelectElectrodesFromBothGrids(),
           JCAR(exclude_channels=[19, 38, 48, 52],
                grids=[jch.speech_grid(), jch.motor_grid()],
                layout=jch.default_layout()),
           sel]
    post = [JZ(sel(np.zeros((1, 128), np.float32)),
               sel(np.ones((1, 128), np.float32)))]
    return pre, post


def _drive(unit, method, messages):
    """Every (stream, message) a unit's subscriber yields for ``messages``,
    given to a JAX unit as the JAX package's message type (its units stamp
    only their own ClosedLoopMessage)."""
    if type(unit).__module__.startswith("dss_tpu."):
        messages = [jmessages.ClosedLoopMessage(**vars(m)) for m in messages]

    async def run():
        out = []
        for msg in messages:
            out += [x async for x in getattr(unit, method)(msg)]
        return out
    return asyncio.run(run())


def _packets(raw, extra=None):
    msgs = [ClosedLoopMessage(data=raw[k:k + 40], fs=1000, received_at=1.0)
            for k in range(0, len(raw) - 39, 40)]
    if extra is not None:
        msgs.append(ClosedLoopMessage(data=extra, fs=1000, received_at=1.0))
    return msgs


@pytest.fixture(scope="module")
def hga_features():
    """The port's and the JAX HighGammaActivity on the 6 s session in
    40-sample packets, then one 100-sample packet (the extract_features
    path): lists of per-message float64 features."""
    raw = _session()
    msgs = _packets(raw[:-100], extra=raw[-100:])
    pre, post, nb = feature_transforms(None)
    port = tunits.HighGammaActivity(tunits.HighGammaActivitySettings(
        fs=1000, nb_electrodes=nb, pre_transforms=pre, post_transforms=post,
        package_size=40, raw_channels=129, device="cpu"))
    jpre, jpost = _jax_transforms()
    ref = junits.HighGammaActivity()
    ref.apply_settings(junits.HighGammaActivitySettings(
        fs=1000, nb_electrodes=64, pre_transforms=jpre, post_transforms=jpost,
        package_size=40, raw_channels=129))
    out = []
    for unit in (port, ref):
        unit.initialize()
        try:
            out.append([m.data for _, m in _drive(unit, "process", msgs)])
        finally:
            unit.shutdown()
    assert len(port.step_ms) == len(msgs) - 1  # packet steps, then a block
    return out


def test_high_gamma_activity_matches_jax(hga_features):
    """Per message: the same number of frames (the first packet trimmed by
    warmup_frames, the 100-sample block through extract_features), float64
    on the wire, features atol 1e-4 (16-section IIR, log and z-score in
    f32)."""
    port, ref = hga_features
    assert len(port) == len(ref) == 148
    assert [len(x) for x in port] == [len(x) for x in ref]
    assert len(port[0]) < 4
    for a, b in zip(port, ref):
        assert a.dtype == np.float64 and a.shape[1] == 64
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_filter_speech_segments_matches_jax(hga_features, tmp_path):
    """The same feature messages through both nVAD units with the
    threshold-VAD checkpoint: the same segments (count, lengths and
    ``previous_frames``), their features atol 1e-4, and the unit's stamps
    in the JAX order."""
    vad = _threshold_vad(tmp_path / "vad.npz")
    feats = hga_features[0]
    msgs = [ClosedLoopMessage(data=f, fs=100, received_at=1.0)
            for f in feats]
    port = tunits.FilterSpeechSegments(tunits.FilterSpeechSegmentsSettings(
        nb_features=64, fs=100, buffer_size=2000, context_frames=50,
        vad_architecture=UnidirectionalVoiceActivityDetector,
        vad_weights_path=vad, vad_parameters=dict(
            nb_layer=2, nb_hidden_units=150, nb_electrodes=64),
        device="cpu"))
    ref = junits.FilterSpeechSegments()
    ref.apply_settings(junits.FilterSpeechSegmentsSettings(
        nb_features=64, fs=100, buffer_size=2000, context_frames=50,
        vad_architecture=JVad, vad_weights_path=vad,
        vad_parameters=dict(nb_layer=2, nb_hidden_units=150,
                            nb_electrodes=64)))
    out = []
    for unit in (port, ref):
        unit.initialize()
        try:
            out.append([m for _, m in _drive(unit, "process", msgs)])
        finally:
            unit.shutdown()
    got, want = out
    assert len(got) == len(want) == 1
    for a, b in zip(got, want):
        assert len(a.data) == len(b.data) > 150
        assert a.previous_frames == b.previous_frames
        np.testing.assert_allclose(a.data, b.data, atol=1e-4)
        assert [n for n, _ in a.stamps] == [n for n, _ in b.stamps] == \
            ["vad_dispatch", "vad_device_done", "seg_close"]
    assert len(port.step_ms) == len(msgs)


@pytest.mark.parametrize("T", [73, 100])
def test_recurrent_decoder_unit_matches_jax(tmp_path, T):
    """One segment of T frames through both decoder units (the same
    checkpoint file, bucket 50): float32 features [T, 20] atol 1e-4 (two
    bidirectional f32 LSTM layers), and the stamps in the JAX order."""
    weights = str(_decoder_npz(tmp_path / "dec.npz"))
    seg = np.random.default_rng(T).normal(size=(T, 64))
    msg = ClosedLoopMessage(data=seg, fs=100, received_at=1.0)
    port = tunits.RecurrentNeuralDecodingModel(
        tunits.RecurrentNeuralDecodingModelSettings(
            path_to_model_weights=weights,
            model=BidirectionalSpeechSynthesisModel,
            params=dict(nb_layer=2, nb_hidden_units=16, nb_electrodes=64),
            prewarm_frames=(50,), device="cpu"))
    ref = junits.RecurrentNeuralDecodingModel()
    ref.apply_settings(junits.RecurrentNeuralDecodingModelSettings(
        path_to_model_weights=weights, model=JDec,
        params=dict(nb_layer=2, nb_hidden_units=16, nb_electrodes=64),
        prewarm_frames=()))
    out = []
    for unit in (port, ref):
        unit.initialize()
        try:
            (_, m), = _drive(unit, "decode", [msg])
            out.append(m)
        finally:
            unit.shutdown()
    got, want = out
    assert got.data.dtype == np.float32 and got.data.shape == (T, 20)
    np.testing.assert_allclose(got.data, np.asarray(want.data), atol=1e-4)
    assert [n for n, _ in got.stamps] == [n for n, _ in want.stamps] == \
        ["dec_dispatch", "dec_device_done"]


def _jax_noise_by_frame(seed, frames):
    """The JAX DSP vocoder's noise for absolute frames 0..frames-1 from
    PRNGKey(seed), as a drop-in for the port's ``gaussian_noise``."""
    rng, table = jax.random.PRNGKey(seed), []
    for _ in range(frames):
        rng, k = jax.random.split(rng)
        table.append(np.asarray(jax.random.normal(k, (160,), jnp.float32)))
    table = torch.as_tensor(np.stack(table))

    def noise(s, batch, first, n, device):
        assert s == seed and batch == 1
        return table[first:first + n][None].to(device)
    return noise


def _features(T, seed):
    rng = np.random.default_rng(seed)
    f = (rng.normal(size=(T, 20)) * 0.3).astype(np.float32)
    f[:, 0] -= 2.0
    f[:, 19] = np.where(np.arange(T) % 10 < 6, 0.3, -0.3)
    return f


def test_delayed_vocoder_unit_matches_jax(monkeypatch):
    """Two words (23 and 37 frames, repeat-padded to 30 and 40) through both
    dsp vocoder units, the JAX vocoder's noise injected into the port's:
    int16 PCM of T x 160 samples within 1 LSB per sample, and the state
    carried across words through the padded frames (70 frames drawn)."""
    monkeypatch.setattr(tdsp, "gaussian_noise", _jax_noise_by_frame(0, 80))
    words = [_features(23, 1), _features(37, 2)]
    msgs = [ClosedLoopMessage(data=w, fs=100, received_at=1.0) for w in words]
    port = tunits.DelayedLPCNetVocoder(tunits.DelayedLPCNetVocoderSettings(
        device="cpu"))
    ref = junits.DelayedLPCNetVocoder()
    ref.apply_settings(junits.DelayedLPCNetVocoderSettings())
    out = []
    for unit in (port, ref):
        unit.initialize()
        try:
            out.append([m for _, m in _drive(unit, "synthesize", msgs)])
        finally:
            if unit is port:
                assert unit._lpcnet._state.frame_ctr == 70
            unit.shutdown()
    for a, b, w in zip(*out, words):
        assert a.data.dtype == np.int16 and len(a.data) == len(w) * 160
        assert np.abs(a.data.astype(np.int32) - b.data).max() <= 1
        assert [n for n, _ in a.stamps] == [n for n, _ in b.stamps] == \
            ["voc_dispatch", "voc_device_done"]
    assert len(port.vocode_ms) == 2


def test_fused_dsp_unit_equals_separate_chain(tmp_path):
    """The port's FusedDecoderVocoder with the dsp backend equals its
    RecurrentNeuralDecodingModel -> DelayedLPCNetVocoder(dsp) chain at the
    same padding bucket (10 frames) bit for bit, features and PCM, over
    two words (the vocoder state carries across them)."""
    weights = str(_decoder_npz(tmp_path / "dec.npz"))
    dec = dict(path_to_model_weights=weights,
               model=BidirectionalSpeechSynthesisModel,
               params=dict(nb_layer=2, nb_hidden_units=16, nb_electrodes=64),
               length_multiple=10, prewarm_frames=(), device="cpu")
    fused = tunits.FusedDecoderVocoder(tunits.FusedDecoderVocoderSettings(
        vocoder_backend="dsp", **dec))
    decoder = tunits.RecurrentNeuralDecodingModel(
        tunits.RecurrentNeuralDecodingModelSettings(**dec))
    vocoder = tunits.DelayedLPCNetVocoder(tunits.DelayedLPCNetVocoderSettings(
        length_multiple=10, device="cpu"))
    rng = np.random.default_rng(4)
    segs = [ClosedLoopMessage(data=rng.normal(size=(T, 64)), fs=100,
                              received_at=1.0) for T in (23, 31)]
    for u in (fused, decoder, vocoder):
        u.initialize()
    try:
        assert not fused._chunked
        f_out = _drive(fused, "decode", segs)
        lpc = [m for _, m in _drive(decoder, "decode", segs)]
        audio = [m for _, m in _drive(vocoder, "synthesize", lpc)]
    finally:
        for u in (fused, decoder, vocoder):
            u.shutdown()
    f_lpc = [m.data for s, m in f_out if s == fused.LPC]
    f_audio = [m.data for s, m in f_out if s == fused.OUTPUT]
    f_word = [m.data for s, m in f_out if s == fused.WORD]
    assert len(f_lpc) == len(f_audio) == len(f_word) == 2
    for a, b in zip(f_lpc, lpc):
        np.testing.assert_array_equal(a, b.data)
    for a, w, b, seg in zip(f_audio, f_word, audio, segs):
        assert a.dtype == np.int16 and len(a) == len(seg.data) * 160
        np.testing.assert_array_equal(a, b.data)
        np.testing.assert_array_equal(w, a)


def test_sox_sink_writes_the_latency_budget(tmp_path, capsys):
    """The port's audio sink on the separate chain's stamps: at shutdown
    the per-stage p50/p95 table in path order, the device round trips
    counted per ``*_device_done`` interval, words over the stall threshold
    counted, and the JAX sink's report keys but its tunnel-floor ones (the
    port leaves ``rpc_floor_ms`` out)."""
    import time

    t0 = time.time() - 1.0
    msgs = [ClosedLoopMessage(
        data=np.full(16, k, np.int16), fs=16000, received_at=t0 - 2.0 * k,
        stamps=(("vad_dispatch", t0 + 0.01), ("vad_device_done", t0 + 0.03),
                ("seg_close", t0 + 0.031), ("dec_dispatch", t0 + 0.032),
                ("dec_device_done", t0 + 0.05 + 0.01 * k),
                ("voc_dispatch", t0 + 0.06 + 0.01 * k),
                ("voc_device_done", t0 + 0.07 + 0.01 * k)))
        for k in range(3)]
    msgs.append(ClosedLoopMessage(data=np.full(16, 9, np.int16), fs=16000,
                                  received_at=None))  # an interior chunk
    reports = []
    for mod in (tunits, junits):
        path = tmp_path / f"{mod.__name__}.json"
        unit = mod.DelayedStdoutForSoX()
        floor = {} if mod is tunits else {"rpc_floor_ms": 1.0}
        unit.apply_settings(mod.SoXOutputSettings(
            budget_path=str(path), stall_threshold_ms=1500.0, **floor))
        unit.initialize()
        for m in msgs:
            asyncio.run(unit.print(m))
        unit.shutdown()
        capsys.readouterr()  # swallow the PCM written to stdout
        reports.append(json.loads(path.read_text()))
    got, want = reports
    tunnel = {"rpc_floor_ms", "tunnel_rpc_share_ms",
              "total_p50_net_of_tunnel_ms", "total_p95_net_of_tunnel_ms"}
    assert sorted(got) == sorted(set(want) - tunnel)
    assert list(got["stages"]) == list(want["stages"])
    assert list(got["stages"])[:2] == ["ingest->vad_dispatch",
                                       "vad_dispatch->vad_device_done"]
    assert got["n_words"] == 3 and got["device_round_trips_per_word"] == 3
    assert got["stall_count"] == want["stall_count"] == 2
    assert abs(got["stages"]["dec_dispatch->dec_device_done"]["p50"]
               - 28.0) < 1.0


@pytest.mark.parametrize("lengths", [
    [100, 120, 150, 160, 250, 260, 270, 90, 300],
    [40, 45, 50, 55, 61, 30, 33, 38],
])
def test_bucket_policy_matches_jax(tmp_path, lengths):
    """The port's copy of the bucket policy picks the JAX package's
    (length_multiple, prewarm buckets) from the same lengths, read back
    from a written .lab file as the JAX reader does."""
    lab = tmp_path / "log.vad.lab"
    lab.write_text("".join(f"{i:.02f}\t{i + n / 100:.02f}\t{n} frames\n"
                           for i, n in enumerate(lengths)))
    got = tpolicy.load_lab_lengths([str(lab)])
    np.testing.assert_array_equal(got, jpolicy.load_lab_lengths([str(lab)]))
    np.testing.assert_array_equal(got, lengths)
    assert tpolicy.choose_policy(got) == jpolicy.choose_policy(got)


def test_segment_policy_labs_pick_the_buckets(tmp_path):
    """``segment_policy_labs`` in the INI: with five or more segments in
    the matched labs the app takes the policy's buckets (the JAX choice),
    with fewer it keeps the configured ones."""
    lengths = [120, 130, 250, 260, 90, 300]
    lab = tmp_path / "a.vad.lab"
    lab.write_text("".join(f"0.00\t1.00\t{n} frames\n" for n in lengths))
    cfg = configparser.ConfigParser()
    cfg.read(DEBUG_INI)
    cfg.set("Decoding", "segment_policy_labs", str(tmp_path / "*.vad.lab"))
    ini = tmp_path / "cfg.ini"
    with open(ini, "w") as fd:
        cfg.write(fd)
    s = build_settings(str(ini), "run", device="cpu")
    mult, prewarm = jpolicy.choose_policy(np.asarray(lengths))
    assert (s.segment_length_multiple, s.segment_prewarm_frames) == \
        (mult, prewarm)
    lab.write_text("0.00\t1.00\t120 frames\n")
    s = build_settings(str(ini), "run", device="cpu")
    assert (s.segment_length_multiple, s.segment_prewarm_frames) == \
        (50, (50, 150, 200, 250, 300))


def test_shipped_ini_graph_writes_the_jax_logs(tmp_path, monkeypatch):
    """config/debug_settings.ini on the CPU resolves to the fully separate
    chain with the dsp vocoder; a 3 s session with one burst replayed
    in-process through it closes one segment and writes every log as the
    JAX app does: log.raw.f64 [-1, 129] f64 (the packets as received),
    log.hga.f64 [-1, 64] f64 (equal to the JAX front end's features, atol
    1e-4), log.vad.lab (start, stop, "N frames"), log.lpc.f32 [-1, 20],
    reco/reco_00001.wav (16 kHz int16, N x 160 samples), the same PCM on
    stdout, and latency_budget.json with the chain's stages."""
    from dataclasses import replace

    raw = _session(3.0, (1.0, 1.4))
    s = build_settings(str(DEBUG_INI), "run", device="cpu")
    assert not s.fused_frontend and not s.fused_decoder
    assert s.vocoder_backend == "dsp"
    s = replace(s, destination_dir=str(tmp_path / "run"),
                vad_model_weights=_threshold_vad(tmp_path / "vad.npz"),
                segment_prewarm_frames=(100,))

    class Replayed(Neuroprosthesis):
        CONNECTOR = tunits.PacketReplay()

        def configure_source(self):
            self.CONNECTOR.apply_settings(tunits.PacketReplaySettings(
                data=raw, fs=1000))

    host_calls = []
    library = tdsp_ops._host.library

    class Counted:
        """The host library, recording (B, T) of each sample-loop call."""

        def dss_dsp_synthesis_host(self, *args):
            host_calls.append(tuple(args[-2:]))
            return library().dss_dsp_synthesis_host(*args)
    monkeypatch.setattr(tdsp_ops._host, "library", Counted)
    host_launches = tdsp_ops.dsp_synthesis_host.launches
    system = Replayed(s)
    with open(tmp_path / "audio.pcm", "w") as fd, \
            contextlib.redirect_stdout(fd):
        run_system(system)
    run = tmp_path / "run"
    log_raw = np.fromfile(run / "log.raw.f64", np.float64).reshape(-1, 129)
    np.testing.assert_array_equal(log_raw, raw[:len(log_raw)])
    assert len(log_raw) == 3000
    hga = np.fromfile(run / "log.hga.f64", np.float64).reshape(-1, 64)
    jpre, jpost = _jax_transforms()
    from dss_tpu.ops import HighGammaExtractor as JHGA
    jx = JHGA(fs=1000, nb_electrodes=64, pre_transforms=jpre,
              post_transforms=jpost)
    st, want = jx.init_state(), []
    for k in range(0, 3000, 40):
        f, st = jx.packet_step(st, jnp.asarray(raw[k:k + 40], jnp.float32))
        want.append(np.asarray(f))
    want = np.concatenate(want)[jx.warmup_frames(40):]
    np.testing.assert_allclose(hga, want, atol=1e-4)
    rows = (run / "log.vad.lab").read_text().splitlines()
    assert len(rows) == 1
    start, stop, frames = rows[0].split("\t")
    n = int(frames.split()[0])
    assert frames == f"{n} frames" and n > 100
    assert f"{float(stop) - float(start):.2f}" == f"{n * 0.01:.2f}"
    lpc = np.fromfile(run / "log.lpc.f32", np.float32).reshape(-1, 20)
    assert lpc.shape == (n, 20) and np.all(np.isfinite(lpc))
    from scipy.io.wavfile import read as wavread
    fs, wav = wavread(run / "reco" / "reco_00001.wav")
    assert fs == 16000 and wav.dtype == np.int16 and wav.shape == (n * 160,)
    pcm = np.fromfile(tmp_path / "audio.pcm", np.int16)
    np.testing.assert_array_equal(pcm, wav)
    budget = json.loads((run / "latency_budget.json").read_text())
    assert budget["n_words"] == 1
    assert budget["device_round_trips_per_word"] == 3
    assert list(budget["stages"])[-2:] == ["voc_device_done->audio_out",
                                           "total"]
    assert isinstance(system.SPEECH_FILTER, tunits.FilterSpeechSegments)
    assert "FUSED_FRONTEND" not in vars(system)
    # The vocoder ran the sample loop compiled for the host once, for the
    # word (padded to a multiple of 10 frames); the unit warmed nothing for
    # dsp.
    assert host_calls == [(1, -(-n // 10) * 10)]
    assert tdsp_ops.dsp_synthesis_host.launches == host_launches + 1
