"""The port's public vocoder API on the CPU: LPCNet, BatchedLPCNet,
LPCFeatureFile, the packaged-weights helpers, the wav helpers and the
offline synthesize app, against the JAX package where it has a
counterpart.

Checkpoints are tiny (widths of tests/test_torch_vocoder.py) and written
with numpy; the stochastic paths of the two packages draw different noise,
so what is compared is the int16 conversion on the same float PCM, shapes,
state handling and determinism.
"""

import os

import jax
import numpy as np
import pytest
import torch

from dss_tpu import utils as jutils
from dss_tpu import vocoder as jvoc
from dss_tpu.vocoder import net as jnet
from dss_tpu_torch import vocoder as tvoc
from dss_tpu_torch.apps import synthesize
from dss_tpu_torch.utils import audio as taudio
from dss_tpu_torch.vocoder import lpcnet as tlpcnet
from dss_tpu_torch.vocoder import net as tnet

torch.set_num_threads(1)
TINY = dict(gru_a_units=16, gru_b_units=8, cond_dim=8, embed_dim=8)


def _tiny_params(bunch, seed=0):
    jm = jnet.LPCNetModel(bunch=bunch, **TINY)
    return jax.tree_util.tree_map(np.asarray,
                                  jm.init(jax.random.PRNGKey(seed)))


def _features(rng, *lead):
    f = rng.normal(size=lead + (20,)).astype(np.float32) * 0.3
    f[..., 0] += -6.0
    return f


@pytest.fixture(params=[1, 4], ids=["bunch1", "bunch4"])
def weights(request, tmp_path):
    """A tiny checkpoint on disk, at bunch 1 and at bunch 4."""
    path = tmp_path / f"voc_b{request.param}.npz"
    np.savez(path, **_tiny_params(request.param))
    return str(path), request.param


def test_packaged_weights_match_the_jax_package():
    """packaged_weights / packaged_weights_bunched name the same shipped
    files as the JAX package, for every bunch it ships and one it does
    not."""
    assert tvoc.packaged_weights() == jvoc.packaged_weights()
    assert tvoc.packaged_weights().endswith("vocoder_speech.npz")
    for bunch in (2, 4, 8, 16):
        assert tvoc.packaged_weights_bunched(bunch) == \
            jvoc.packaged_weights_bunched(bunch)
    assert tvoc.packaged_weights_bunched(8).endswith("vocoder_speech_b8.npz")
    assert tvoc.packaged_weights_bunched() .endswith("vocoder_speech_b2.npz")
    assert tvoc.packaged_weights_bunched(16) is None
    for name in tvoc.__all__:
        assert hasattr(tvoc, name) and hasattr(jvoc, name)


def test_lpcnet_frame_api_shapes_and_state(weights, rng):
    """LPCNet on the CPU: synthesize() gives int16 [160] per frame,
    synthesize_frames() int16 [T*160]; the bunch comes from the
    checkpoint; reset_decoder() returns to the initial state, so the same
    features give the same audio again (noise is keyed by seed and
    absolute frame); warm() leaves the state alone."""
    path, bunch = weights
    voc = tvoc.LPCNet(backend="net", weights=path, seed=5, device="cpu")
    assert voc.model.bunch == bunch
    assert voc.LPCNET_FRAME_SIZE == 160
    feats = _features(rng, 3)
    one = voc.synthesize(feats[0])
    assert one.dtype == np.int16 and one.shape == (160,)
    rest = voc.synthesize_frames(feats[1:])
    assert rest.dtype == np.int16 and rest.shape == (320,)
    assert voc.state.frame_ctr == 3
    voc.warm(2)
    assert voc.state.frame_ctr == 3
    voc.reset_decoder()
    assert voc.state.frame_ctr == 0
    again = voc.synthesize_frames(feats)
    np.testing.assert_array_equal(again, np.concatenate([one, rest]))


def test_lpcnet_state_continuity_over_two_calls(weights, rng):
    """Two calls of 50 frames continue the stream exactly as one call of
    100 frames does (carried GRU state, history, conv context,
    de-emphasis, frame counter)."""
    path, _ = weights
    feats = _features(rng, 100)
    a = tvoc.LPCNet(weights=path, seed=2, device="cpu")
    whole = a.synthesize_frames(feats)
    b = tvoc.LPCNet(weights=path, seed=2, device="cpu")
    halves = np.concatenate([b.synthesize_frames(feats[:50]),
                             b.synthesize_frames(feats[50:])])
    np.testing.assert_array_equal(halves, whole)
    assert whole.shape == (16000,) and np.abs(whole).max() > 0


def test_int16_conversion_equals_the_jax_package(weights, rng, monkeypatch):
    """The same float PCM (values beyond +-1, at the clip points and
    between integers) becomes the same int16 in both packages: scale by
    32767, clip, truncate toward zero."""
    path, _ = weights
    pcm = np.concatenate([
        rng.uniform(-1.2, 1.2, size=317),
        [1.0, -1.0, 32767.5 / 32767, -32768.9 / 32767, 0.99999, -0.99999,
         0.5 / 32767, -0.5 / 32767, 0.0]]).astype(np.float32)
    pcm = np.pad(pcm, (0, 480 - len(pcm)))[None]
    feats = _features(rng, 3)

    jv = jvoc.LPCNet(backend="net", weights=path, use_pallas=False)
    monkeypatch.setattr(
        "dss_tpu.vocoder.lpcnet.net_synthesize_frames",
        lambda *a, **k: (pcm, jv._state))
    want = jv.synthesize_frames(feats)

    tv = tvoc.LPCNet(backend="net", weights=path, device="cpu")
    monkeypatch.setattr(
        tlpcnet, "net_synthesize_frames",
        lambda *a, **k: (torch.as_tensor(pcm), tv.state))
    got = tv.synthesize_frames(feats)
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert got.max() == 32767 and got.min() == -32768


def test_batched_lpcnet(weights, rng):
    """BatchedLPCNet: [N, T, 20] -> int16 [N, T*160]; streams are
    independent (stream 1's audio does not move when its neighbours'
    features do); reset() restarts all streams; a wrong stream count is
    refused."""
    path, bunch = weights
    voc = tvoc.BatchedLPCNet(batch=3, weights=path, seed=1, device="cpu")
    feats = _features(rng, 3, 2)
    out = voc.synthesize_frames(feats)
    assert out.dtype == np.int16 and out.shape == (3, 320)
    assert tuple(voc.state.exc_idx.shape) == \
        ((3,) if bunch == 1 else (3, bunch))
    other = feats.copy()
    other[0] += 1.0
    other[2] -= 1.0
    voc.reset()
    assert voc.state.frame_ctr == 0
    np.testing.assert_array_equal(voc.synthesize_frames(other)[1], out[1])
    with pytest.raises(ValueError):
        voc.synthesize_frames(feats[:2])


@pytest.mark.parametrize("cls", ["LPCNet", "BatchedLPCNet"])
def test_backend_dsp_is_refused_not_replaced(cls, weights):
    """backend='dsp' is the DSP vocoder, not the neural one run in its
    place: it ignores the weights, as the JAX package does, and its
    output does not depend on them; an unknown backend and a net backend
    without weights raise ValueError."""
    path, _ = weights
    make = (lambda **kw: tvoc.LPCNet(device="cpu", **kw)) if cls == "LPCNet" \
        else (lambda **kw: tvoc.BatchedLPCNet(batch=2, device="cpu", **kw))
    voc = make(backend="dsp", weights=path)
    assert voc.backend == "dsp" and not hasattr(voc, "model")
    feats = np.zeros((2, 3, 20), np.float32)
    if cls == "LPCNet":
        out = voc.synthesize_frames(feats[0])
        want = make(backend="dsp").synthesize_frames(feats[0])
    else:
        out = voc.synthesize_frames(feats)
        want = make(backend="dsp").synthesize_frames(feats)
    np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError):
        make(backend="wavenet", weights=path)
    with pytest.raises(ValueError, match="weights"):
        make(backend="net")


def test_lpc_feature_file_on_a_written_f32(tmp_path, rng):
    """LPCFeatureFile yields the first 20 of 36 features per frame of an
    .f32 dump, as the JAX package's does, and loops when asked."""
    raw = rng.normal(size=(7, 36)).astype(np.float32)
    path = str(tmp_path / "dump.f32")
    raw.tofile(path)
    got = np.stack(list(tvoc.LPCFeatureFile(path)))
    want = np.stack(list(jvoc.LPCFeatureFile(path)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, raw[:, :20])
    looped = tvoc.LPCFeatureFile(path, loop=True)
    frames = [next(looped) for _ in range(9)]
    np.testing.assert_array_equal(frames[7], raw[0, :20])
    np.testing.assert_array_equal(frames[8], raw[1, :20])


def test_wav_round_trip_and_peak_normalize(tmp_path, rng):
    """write_wav / read_wav round-trip int16 at 16 kHz, files are
    interchangeable with the JAX package's helpers, and peak_normalize
    equals the JAX package's on random, silent and empty audio."""
    pcm = rng.integers(-20000, 20000, size=4000).astype(np.int16)
    path = str(tmp_path / "a.wav")
    taudio.write_wav(path, pcm)
    fs, back = taudio.read_wav(path)
    assert fs == 16000 and back.dtype == np.int16
    np.testing.assert_array_equal(back, pcm)
    fs_j, back_j = jutils.read_wav(path)
    assert fs_j == 16000
    np.testing.assert_array_equal(back_j, pcm)
    for audio in (pcm, np.zeros(10, np.int16), np.zeros(0, np.int16),
                  (pcm // 50).astype(np.int16)):
        np.testing.assert_array_equal(taudio.peak_normalize(audio),
                                      jutils.peak_normalize(audio))
    np.testing.assert_array_equal(
        taudio.peak_normalize(pcm, headroom_db=1.0, gain_db=0.0),
        jutils.peak_normalize(pcm, headroom_db=1.0, gain_db=0.0))


@pytest.mark.parametrize("kind", ["npy", "f32"])
def test_synthesize_app_on_the_cpu(tmp_path, rng, weights, kind):
    """apps/synthesize.py with --device cpu: .npy and .f32 features to a
    16 kHz int16 wav of frames x 160 samples, equal to LPCNet on the same
    features."""
    path, _ = weights
    feats = _features(rng, 3)
    if kind == "npy":
        src = str(tmp_path / "feats.npy")
        np.save(src, np.pad(feats, ((0, 0), (0, 2))))  # [T, >= 20]
    else:
        src = str(tmp_path / "feats.f32")
        np.pad(feats, ((0, 0), (0, 16))).astype(np.float32).tofile(src)
    out = str(tmp_path / "out.wav")
    synthesize.main([src, out, "--backend", "net", "--weights", path,
                     "--device", "cpu"])
    fs, pcm = taudio.read_wav(out)
    assert fs == 16000 and pcm.dtype == np.int16 and pcm.shape == (480,)
    want = tvoc.LPCNet(weights=path, device="cpu").synthesize_frames(feats)
    np.testing.assert_array_equal(pcm, want)


def test_synthesize_app_picks_packaged_checkpoints_and_refuses(tmp_path,
                                                               monkeypatch):
    """With --backend net, --bunch picks the packaged checkpoint as
    packaged_weights_bunched does (1 = the flagship); the default backend
    is dsp, which takes no weights and runs; a feature file of another kind
    or width exits."""
    np.save(tmp_path / "feats.npy", np.zeros((2, 20), np.float32))
    src, out = str(tmp_path / "feats.npy"), str(tmp_path / "o.wav")
    picked = []

    class Fake:
        def __init__(self, backend, weights, device):
            picked.append((backend, weights and os.path.basename(weights),
                           device))

        def synthesize_frames(self, feats):
            return np.zeros(len(feats) * 160, np.int16)

    monkeypatch.setattr(synthesize, "LPCNet", Fake)
    net = ["--backend", "net"]
    synthesize.main([src, out, *net, "--device", "cpu"])
    synthesize.main([src, out, *net, "--bunch", "4", "--device", "cpu"])
    synthesize.main([src, out, *net, "--bunch", "8"])
    synthesize.main([src, out, "--device", "cpu"])
    assert picked == [("net", "vocoder_speech.npz", "cpu"),
                      ("net", "vocoder_speech_b4.npz", "cpu"),
                      ("net", "vocoder_speech_b8.npz", None),
                      ("dsp", None, "cpu")]
    with pytest.raises(SystemExit):
        synthesize.main([src, out, *net, "--bunch", "16", "--device", "cpu"])
    monkeypatch.undo()
    synthesize.main([src, out, "--backend", "dsp", "--device", "cpu"])
    fs, pcm = taudio.read_wav(out)
    assert fs == 16000 and pcm.shape == (320,)
    with pytest.raises(SystemExit):
        synthesize.main([str(tmp_path / "feats.txt"), out])
    np.save(tmp_path / "narrow.npy", np.zeros((2, 19), np.float32))
    with pytest.raises(SystemExit):
        synthesize.main([str(tmp_path / "narrow.npy"), out])


def test_default_device_is_the_card():
    """Without device='cpu' the API asks for CUDA and, where there is no
    card, raises instead of running on the CPU."""
    if torch.cuda.is_available():
        voc = tvoc.LPCNet(weights=tvoc.packaged_weights())
        assert voc.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tvoc.LPCNet(weights=tvoc.packaged_weights())
    assert tnet.LPCNetModel().bunch == 1
