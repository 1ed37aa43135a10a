"""The port's online word path as a whole, on the CPU.

* The synthetic 6 s session of tools/make_verify_fixtures.py (129 channels
  at 1 kHz, a loud burst at 2.0-3.5 s) and its threshold-VAD checkpoint go
  through front end -> nVAD -> segmenting -> decoder -> greedy vocoder in
  both packages; segment boundaries must be equal, features close, and the
  PCM close over a short horizon (two frames: the greedy loop is chaotic).
* The port's two fused units run through the port's own graph with an
  in-process packet source, and every word's PCM is frames x 160 samples.
* The word unit's chunked emission equals its single-shot path.
* The package imports neither jax nor anything of dss_tpu.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.models import BidirectionalSpeechSynthesisModel as JDec
from dss_tpu.models import UnidirectionalVoiceActivityDetector as JVad
from dss_tpu.models.torch_port import from_torch_state_dict
from dss_tpu.ops import CommonAverageReferencing as JCAR
from dss_tpu.ops import HighGammaExtractor as JHGA
from dss_tpu.ops import ZScoreNormalization as JZ
from dss_tpu.ops.ringbuffer import SpeechSegmentHistory as JHist
from dss_tpu.ops.ringbuffer import VoiceActivityDetectionSmoothing as JSmooth
from dss_tpu.utils import channels as jch
from dss_tpu.vocoder import net as jnet
from dss_tpu_torch import runtime as ez
from dss_tpu_torch.apps.decode_online import feature_transforms
from dss_tpu_torch.convert import lstm_state_dict, vocoder_params
from dss_tpu_torch.models.decoder import BidirectionalSpeechSynthesisModel
from dss_tpu_torch.models.vad import UnidirectionalVoiceActivityDetector
from dss_tpu_torch.ops.hga import HighGammaExtractor
from dss_tpu_torch.ops.ringbuffer import SpeechSegmentHistory, \
    VoiceActivityDetectionSmoothing
from dss_tpu_torch.runtime.units import FusedDecoderVocoder, \
    FusedDecoderVocoderSettings, FusedFrontendVad, FusedFrontendVadSettings, \
    PacketReplay, PacketReplaySettings
from dss_tpu_torch.vocoder import net as tnet

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _session(seconds=6.0, burst=(2.0, 3.5)):
    """tools/make_verify_fixtures.py's session: noise, loud burst."""
    fs = 1000
    rng = np.random.default_rng(7)
    T = int(seconds * fs)
    envelope = np.full(T, 0.05)
    envelope[int(burst[0] * fs):int(burst[1] * fs)] = 2.0
    return rng.normal(size=(T, 129)) * envelope[:, None]


def _threshold_vad():
    """tools/make_verify_fixtures.py's threshold-VAD state_dict: speech iff
    mean(feature) > -2.5, as a 2-layer LSTM(64 -> 150) + classifier."""
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
    return sd


def _jax_frontend():
    pre = [jch.SelectElectrodesFromBothGrids(),
           JCAR(exclude_channels=[19, 38, 48, 52],
                grids=[jch.speech_grid(), jch.motor_grid()],
                layout=jch.default_layout()),
           jch.SelectElectrodesOverSpeechAreas()]
    post = [JZ(jch.SelectElectrodesOverSpeechAreas()(np.zeros((1, 128),
                                                               np.float32)),
               jch.SelectElectrodesOverSpeechAreas()(np.ones((1, 128),
                                                             np.float32)))]
    return JHGA(fs=1000, nb_electrodes=64, pre_transforms=pre,
                post_transforms=post)


def _segments(feats_per_packet, labels_per_packet, smooth, hist):
    segs = []
    for f, lab in zip(feats_per_packet, labels_per_packet):
        d, p = smooth.insert(f.astype(np.float32), lab)
        segs += hist.insert(d, p)
    return segs


def test_slice_matches_jax_on_synthetic_session():
    """Front end + nVAD + segmenting + decoder + greedy vocoder, port vs
    JAX.  Features atol 1e-4 (16-section IIR, log, z-score in f32);
    labels and segment boundaries exact; decoded features atol 1e-4;
    vocoder PCM (shipped flagship checkpoint, greedy, each side on its own
    decoded features) atol 1e-3 over the first two frames."""
    raw = _session().astype(np.float32)
    sd = _threshold_vad()
    jvad = JVad(2, 150, 64)
    jvp = from_torch_state_dict(sd, 2, False, "classifier")
    tvad = UnidirectionalVoiceActivityDetector(2, 150, 64).eval()
    tvad.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    jx = _jax_frontend()
    pre, post, _ = feature_transforms(None)
    tx = HighGammaExtractor(fs=1000, nb_electrodes=64, pre_transforms=pre,
                            post_transforms=post, device="cpu")
    js, ts = jx.init_state(), tx.init_state()
    jv, tv = jvad.create_new_initial_state(1), tvad.create_new_initial_state(1)
    j_vad = jax.jit(jvad.apply)
    jf, tf, jl, tl = [], [], [], []
    with torch.no_grad():
        for k in range(0, len(raw), 40):
            f, js = jx.packet_step(js, jnp.asarray(raw[k:k + 40]))
            lg, jv = j_vad(jvp, f[None], jv)
            jf.append(np.asarray(f))
            jl.append(np.asarray(jnp.argmax(lg, -1))[0])
            f, ts = tx.packet_step(ts, torch.as_tensor(raw[k:k + 40]))
            lg, tv = tvad(f[None], tv)
            tf.append(f.numpy())
            tl.append(torch.argmax(lg, -1)[0].numpy())
    w = tx.warmup_frames(40)
    jf[0], tf[0], jl[0], tl[0] = jf[0][w:], tf[0][w:], jl[0][w:], tl[0][w:]
    np.testing.assert_allclose(np.concatenate(tf), np.concatenate(jf),
                               atol=1e-4)
    np.testing.assert_array_equal(np.concatenate(tl), np.concatenate(jl))
    j_segs = _segments(jf, jl, JSmooth(64, 5), JHist(64, 2000, 50))
    t_segs = _segments(tf, tl, VoiceActivityDetectionSmoothing(64, 5),
                       SpeechSegmentHistory(64, 2000, 50))
    assert len(t_segs) == len(j_segs) >= 1
    assert [len(s) for s in t_segs] == [len(s) for s in j_segs]

    jdec = JDec(2, 100, 64)
    jdp = jax.tree_util.tree_map(np.asarray, jdec.init(jax.random.PRNGKey(0)))
    tdec = BidirectionalSpeechSynthesisModel(2, 100, 64).eval()
    tdec.load_state_dict(lstm_state_dict(jdp, "regressor"))
    seg_j, seg_t = j_segs[0], t_segs[0]
    feats_j = np.asarray(jdec.apply(jdp, jnp.asarray(seg_j[None]))[0])
    with torch.no_grad():
        feats_t = tdec(torch.as_tensor(seg_t[None]))[0]
    np.testing.assert_allclose(feats_t.numpy(), feats_j, atol=1e-4)

    with np.load(REPO / "weights" / "vocoder_speech.npz") as f:
        vp = {k: f[k] for k in f.files}
    jm = jnet.LPCNetModel.from_params(vp)
    pcm_j, _ = jnet.net_synthesize_frames(
        jm, {k: jnp.asarray(v) for k, v in vp.items()},
        jnet.net_vocoder_init(jm, 1), jnp.asarray(feats_j[:, :2]),
        greedy=True)
    tp = vocoder_params(vp)
    tm = tnet.LPCNetModel.from_params(tp)
    pcm_t, _ = tnet.net_synthesize_frames(
        tm, tp, tnet.net_vocoder_init(tm, 1, device="cpu"), feats_t[:, :2],
        greedy=True)
    assert pcm_t.shape == (1, 320)
    np.testing.assert_allclose(pcm_t.numpy(), np.asarray(pcm_j), atol=1e-3)


def _tiny_vocoder_npz(path, bunch=1):
    """A random checkpoint at tiny width, made with numpy: bunch 1, or a
    bunched one with its per-lag tables, per-sub-sample heads and
    correction embeddings."""
    rng = np.random.default_rng(0)
    ga, gb, cd, ed = 16, 8, 8, 8

    def g(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)

    z = lambda n: np.zeros(n, np.float32)  # noqa: E731
    extra = {}
    for j in range(1, bunch):
        extra.update({
            f"emb_sig_l{j}": g(256, ed), f"emb_exc_l{j}": g(256, ed),
            f"fc_out1_w_b{j}": g(gb, 256), f"fc_out2_w_b{j}": g(gb, 256),
            f"fc_out1_g_b{j}": np.ones(256, np.float32),
            f"fc_out2_g_b{j}": np.ones(256, np.float32),
            f"fc_out_b_b{j}": g(256) * 0.1,
            f"bunch_exc_emb_b{j}": g(256, 256),
            f"bunch_pred_emb_b{j}": g(256, 256)})
    np.savez(path, emb_sig=g(256, ed), emb_pred=g(256, ed), emb_exc=g(256, ed),
             conv1_w=g(60, cd), conv1_b=z(cd), conv2_w=g(3 * cd, cd),
             conv2_b=z(cd), fc1_w=g(cd, cd), fc1_b=z(cd), fc2_w=g(cd, cd),
             fc2_b=z(cd), gru_a_wx=g((2 * bunch + 1) * ed + cd, 3 * ga),
             gru_a_wh=g(ga, 3 * ga), gru_a_bx=z(3 * ga), gru_a_bh=z(3 * ga),
             gru_a_mask=np.ones((ga, 3 * ga), np.float32),
             gru_b_wx=g(ga + cd, 3 * gb), gru_b_wh=g(gb, 3 * gb),
             gru_b_bx=z(3 * gb), gru_b_bh=z(3 * gb), fc_out1_w=g(gb, 256),
             fc_out2_w=g(gb, 256), fc_out1_g=np.ones(256, np.float32),
             fc_out2_g=np.ones(256, np.float32), fc_out_b=z(256), **extra)


class _Collect(ez.Unit):
    AUDIO = ez.InputStream(ez.ClosedLoopMessage)
    WORD = ez.InputStream(ez.TimeSeriesMessage)
    LPC = ez.InputStream(ez.TimeSeriesMessage)

    def initialize(self):
        self.audio, self.words, self.lpc = [], [], []

    @ez.subscriber(AUDIO)
    async def on_audio(self, msg):
        self.audio.append(np.asarray(msg.data))

    @ez.subscriber(WORD)
    async def on_word(self, msg):
        self.words.append(np.asarray(msg.data))

    @ez.subscriber(LPC)
    async def on_lpc(self, msg):
        self.lpc.append(np.asarray(msg.data))


def test_fused_units_run_through_the_port_graph(tmp_path):
    """PacketReplay -> FusedFrontendVad -> FusedDecoderVocoder -> sink on
    the CPU: at least one segment closes; each word's int16 PCM holds
    frames x 160 samples and equals its concatenated audio chunks."""
    _run_fused_units_through_the_graph(tmp_path, 1)


def test_fused_units_run_through_the_port_graph_bunched(tmp_path):
    """The same with a bunch-4 vocoder checkpoint: the word unit reads the
    bunch from the file and runs the bunched sampler."""
    _run_fused_units_through_the_graph(tmp_path, 4)


def _run_fused_units_through_the_graph(tmp_path, bunch):
    weights = tmp_path / "voc_tiny.npz"
    _tiny_vocoder_npz(weights, bunch)
    vad = tmp_path / "vad.npz"
    np.savez(vad, **_threshold_vad())
    pre, post, nb = feature_transforms(None)

    class System(ez.System):
        SOURCE = PacketReplay()
        FRONTEND = FusedFrontendVad()
        WORDS = FusedDecoderVocoder()
        SINK = _Collect()

        def configure(self):
            self.SOURCE.apply_settings(PacketReplaySettings(
                data=_session(2.0, (0.8, 1.1)), fs=1000))
            self.FRONTEND.apply_settings(FusedFrontendVadSettings(
                nb_features=nb, fs=1000, buffer_size=2000, context_frames=10,
                pre_transforms=pre, post_transforms=post,
                vad_architecture=UnidirectionalVoiceActivityDetector,
                vad_weights_path=vad,
                vad_parameters=dict(nb_layer=2, nb_hidden_units=150,
                                    nb_electrodes=nb),
                device="cpu"))
            self.WORDS.apply_settings(FusedDecoderVocoderSettings(
                path_to_model_weights=None,
                model=BidirectionalSpeechSynthesisModel,
                params=dict(nb_layer=2, nb_hidden_units=16, nb_electrodes=nb),
                vocoder_weights=str(weights), prewarm_frames=(),
                device="cpu"))

        def network(self):
            return ((self.SOURCE.OUTPUT, self.FRONTEND.INPUT),
                    (self.FRONTEND.OUTPUT, self.WORDS.INPUT),
                    (self.WORDS.OUTPUT, self.SINK.AUDIO),
                    (self.WORDS.WORD, self.SINK.WORD),
                    (self.WORDS.LPC, self.SINK.LPC))

    system = System()
    ez.run_system(system)
    sink = system.SINK
    assert len(sink.words) >= 1
    assert len(sink.lpc) == len(sink.words)
    for lpc, word in zip(sink.lpc, sink.words):
        assert lpc.shape[1] == 20
        assert word.dtype == np.int16
        assert len(word) == len(lpc) * 160
    np.testing.assert_array_equal(np.concatenate(sink.audio),
                                  np.concatenate(sink.words))
    assert system.FRONTEND.step_ms and system.WORDS.word_ms
    assert system.WORDS._voc.model.bunch == bunch


def _run_word_unit(weights, nb, T, length_multiple, chunk_emission):
    """One word of T frames through a fresh FusedDecoderVocoder on the CPU:
    (OUTPUT chunks, WORD pcm, LPC features, every (stream name, message)
    in the order published)."""
    import asyncio

    unit = FusedDecoderVocoder(FusedDecoderVocoderSettings(
        path_to_model_weights=None, model=BidirectionalSpeechSynthesisModel,
        params=dict(nb_layer=2, nb_hidden_units=16, nb_electrodes=nb),
        vocoder_weights=str(weights), length_multiple=length_multiple,
        prewarm_frames=(), chunk_emission=chunk_emission, device="cpu"))
    unit.initialize()
    seg = np.random.default_rng(3).normal(size=(T, nb)).astype(np.float32)
    msg = ez.ClosedLoopMessage(data=seg, fs=100, received_at=0.0)

    async def drain():
        return [(s, m) async for s, m in unit.decode(msg)]

    try:
        out = asyncio.run(drain())
    finally:
        unit.shutdown()
    chunks = [m.data for s, m in out if s == unit.OUTPUT]
    word, = [m.data for s, m in out if s == unit.WORD]
    lpc, = [m.data for s, m in out if s == unit.LPC]
    return chunks, word, lpc, [(s.stream.name, m) for s, m in out]


@pytest.mark.parametrize("T, length_multiple", [(73, 50), (30, 100)])
def test_chunked_emission_equals_single_shot(tmp_path, T, length_multiple):
    """The word unit's chunked head/tail emission gives the same WORD PCM,
    bit for bit, as single-shot decode + vocode (fixed 50-frame blocks and
    noise keyed by absolute frame), for words that are not a multiple of
    the 50-frame chunk.  Each emitted chunk holds its valid frames x 160
    samples; a chunk wholly in the repeat-pad is clamped to nothing and
    shipped only when it is the word's last (the word-complete stamp)."""
    _check_chunked_emission(tmp_path, T, length_multiple, 1)


@pytest.mark.parametrize("T, length_multiple, bunch",
                         [(73, 50, 2), (30, 100, 8)])
def test_chunked_emission_equals_single_shot_bunched(tmp_path, T,
                                                     length_multiple, bunch):
    """The same with bunched vocoder checkpoints (bunch 2 and 8): the
    bunched sampler keeps the 50-frame block discipline, so chunked
    emission equals single shot bit for bit."""
    _check_chunked_emission(tmp_path, T, length_multiple, bunch)


def _check_chunked_emission(tmp_path, T, length_multiple, bunch):
    weights = tmp_path / "voc_tiny.npz"
    _tiny_vocoder_npz(weights, bunch)
    nb = 64
    chunks, word, lpc, msgs = _run_word_unit(weights, nb, T,
                                             length_multiple, True)
    ref_chunks, ref_word, ref_lpc, ref_msgs = _run_word_unit(
        weights, nb, T, length_multiple, False)
    assert word.dtype == np.int16 and len(word) == T * 160
    np.testing.assert_array_equal(word, ref_word)
    np.testing.assert_array_equal(lpc, ref_lpc)
    assert len(ref_chunks) == 1
    np.testing.assert_array_equal(ref_chunks[0], ref_word)
    n_chunks = -(-T // length_multiple) * length_multiple // 50
    valid = [max(0, min(T - k * 50, 50)) for k in range(n_chunks)]
    want = [v * 160 for k, v in enumerate(valid) if v or k == n_chunks - 1]
    assert [len(c) for c in chunks] == want
    np.testing.assert_array_equal(np.concatenate(chunks), word)
    # The emission protocol the audio sink reads: LPC, the first chunk
    # with the word's latency stamps, later chunks anonymized, the last of
    # several stamped as the word's completion, WORD anonymized.
    for got, n in ((msgs, len(want)), (ref_msgs, 1)):
        assert [name for name, _ in got] == \
            ["LPC"] + ["OUTPUT"] * n + ["WORD"]
        first, *rest = [m for name, m in got if name == "OUTPUT"]
        assert first.received_at == 0.0
        assert [k for k, _ in first.stamps] == ["dv_dispatch",
                                                 "dv_device_done"]
        for m in rest[:-1] + [got[-1][1]]:
            assert m.received_at is None and m.stamps == ()
        if rest:
            assert rest[-1].received_at == 0.0
            assert [k for k, _ in rest[-1].stamps] == ["dv_dispatch",
                                                        "dv_word_complete"]


def test_bunched_word_unit_matches_jax(tmp_path):
    """The word unit with a tiny bunch-4 checkpoint against the JAX
    package on the same segment: the unit's decoder (padded to its bucket)
    and the JAX decoder with the same weights give features within 1e-4,
    and the unit's vocoder (the model, parameters and sampler weights it
    chose from the file's bunch) gives greedy PCM within 1e-3 of the JAX
    bunched scan path over the first two frames, each side on its own
    decoded features."""
    weights = tmp_path / "voc_tiny_b4.npz"
    _tiny_vocoder_npz(weights, 4)
    nb, T = 64, 30
    unit = FusedDecoderVocoder(FusedDecoderVocoderSettings(
        path_to_model_weights=None, model=BidirectionalSpeechSynthesisModel,
        params=dict(nb_layer=2, nb_hidden_units=16, nb_electrodes=nb),
        vocoder_weights=str(weights), prewarm_frames=(), device="cpu"))
    unit.initialize()
    try:
        voc = unit._voc
        assert voc.model.bunch == 4
        seg = np.random.default_rng(3).normal(size=(T, nb)).astype(np.float32)
        pred_t, feats_t = unit._padded_features(seg, T)
        state = tnet.net_vocoder_init(voc.model, 1, device="cpu")
        assert tuple(state.exc_idx.shape) == (1, 4)
        pcm_t, _ = tnet.net_synthesize_frames(
            voc.model, voc.params, state, feats_t[:, :2],
            greedy=True, sampler_weights=voc.sampler_w)
        sd = {k: v.numpy() for k, v in unit._model.state_dict().items()}
    finally:
        unit.shutdown()

    jdec = JDec(2, 16, nb)
    jdp = from_torch_state_dict(sd, 2, True, "regressor")
    feats_j = np.asarray(jdec.apply(jdp, jnp.asarray(seg[None]))[0])
    np.testing.assert_allclose(pred_t.numpy(), feats_j, atol=1e-4)
    with np.load(weights) as f:
        vp = {k: jnp.asarray(f[k]) for k in f.files}
    jm = jnet.LPCNetModel.from_params(vp)
    assert jm.bunch == 4
    pcm_j, _ = jnet.net_synthesize_frames(
        jm, vp, jnet.net_vocoder_init(jm, 1), jnp.asarray(feats_j[:, :2]),
        greedy=True)
    assert pcm_t.shape == (1, 320)
    np.testing.assert_allclose(pcm_t.numpy(), np.asarray(pcm_j), atol=1e-3)


def test_package_imports_no_jax_and_no_dss_tpu():
    """No source line of dss_tpu_torch imports jax or dss_tpu, and every
    module imports in a fresh interpreter where jax cannot be imported."""
    pkg = REPO / "dss_tpu_torch"
    bad = re.compile(r"^\s*(from|import)\s+(jax|dss_tpu)(\.|\s|$)")
    modules = []
    for path in sorted(pkg.rglob("*.py")):
        for line in path.read_text().splitlines():
            assert not bad.match(line), f"{path}: {line}"
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        modules.append(".".join(parts))
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'dss_tpu' or k.startswith('dss_tpu.') "
            "for k in sys.modules)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
