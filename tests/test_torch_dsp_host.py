"""The DSP vocoder's sample loop compiled for the host
(csrc/dsp_synthesis_host.cpp through ``ops/dsp_synthesis.py::
dsp_synthesis_host``), which CPU tensors now take:

* bit for bit with the plain numpy loop ``dsp_synthesis_plain`` (the serial
  reference the card's kernel D1 is held to at the parity tolerance), pcm
  and carried state, at one
  stream x 260 frames and eight x 50, voiced and unvoiced frames, periods
  32-256, and at T = 0 and T = 1;
* 100 frames == 50 + 50 through ``vocoder/dsp.py``, bit for bit;
* against the JAX package's ``lax.scan`` (dss_tpu/vocoder/dsp.py) on the
  same features and the JAX vocoder's noise, at the tolerance of
  tests/test_torch_dsp.py's D1 parity test (float PCM atol 1e-5, int16
  within 1 LSB, pitch phase exact, filter and de-emphasis memory atol
  1e-5);
* the training path's synthesis queue on the CPU: one 3600-frame job in
  under 5 s (the numpy loop took minutes);
* no fallback: without a host compiler, or when the build fails, the CPU
  path raises and the plain loop is not called.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.vocoder import dsp as jdsp
from dss_tpu_torch.ops import _host
from dss_tpu_torch.ops import dsp_synthesis as d1
from dss_tpu_torch.train.synth_queue import AsynchronousSynthesisQueue
from dss_tpu_torch.vocoder import dsp as tdsp

torch.set_num_threads(1)


def _loop_inputs(batch, frames, seed):
    """Seeded sample-loop inputs: features with voiced and unvoiced frames
    and periods 32-256 through the frame-rate part, Gaussian noise and a
    nonzero carried state."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, frames, 20)).astype(np.float32) * 0.3
    feats[..., 0] -= 2.0
    feats[..., 18] = rng.uniform(-1.36, 3.12, size=(batch, frames))
    feats[..., 19] = np.where(rng.random((batch, frames)) < 0.6,
                              rng.uniform(0.0, 0.5, (batch, frames)),
                              rng.uniform(-0.5, -0.2, (batch, frames)))
    if frames >= 2:
        feats[:, :2, 18] = (-1.36, 3.12)  # periods 32 and 256
    params = tdsp.frame_parameters(torch.as_tensor(feats))
    noise = torch.as_tensor(rng.normal(size=(batch, frames, 160))
                            .astype(np.float32))
    carry = d1.DspCarry(
        torch.as_tensor(rng.normal(size=(batch, 16)).astype(np.float32)) * .1,
        torch.as_tensor(rng.integers(-3, 200, batch).astype(np.int32)),
        torch.as_tensor(rng.normal(size=batch).astype(np.float32)) * 0.1)
    return (*params, noise), carry


@pytest.mark.parametrize("batch, frames", [(1, 260), (8, 50), (3, 1),
                                           (2, 0)])
def test_host_loop_equals_the_plain_version(batch, frames):
    inputs, carry = _loop_inputs(batch, frames, 10 * batch + frames)
    if frames >= 2:
        voiced, period = inputs[3], inputs[4]
        assert voiced.any() and not voiced.all()
        assert int(period.min()) == 32 and int(period.max()) == 256
    before = d1.dsp_synthesis_host.launches
    pcm, out = d1.dsp_synthesis(*inputs, carry)
    assert d1.dsp_synthesis_host.launches == before + (1 if frames else 0)
    want, want_out = d1.dsp_synthesis_plain(*inputs, carry)
    assert pcm.shape == want.shape == (batch, frames * 160)
    assert torch.equal(pcm, want)
    for a, b in zip(out, want_out):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if frames:
        assert float(pcm.abs().max()) > 0.05


def test_host_loop_checks_its_inputs():
    inputs, carry = _loop_inputs(2, 5, 3)
    bad_period = inputs[:4] + (inputs[4].float(),) + inputs[5:]
    with pytest.raises(TypeError, match="int32 period"):
        d1.dsp_synthesis_host(*bad_period, carry)
    with pytest.raises(ValueError, match="noise must be"):
        d1.dsp_synthesis_host(*inputs[:5], inputs[5][:, :, :80], carry)


def test_host_loop_leaves_its_inputs_alone():
    inputs, carry = _loop_inputs(2, 20, 5)
    saved = [t.clone() for t in (*inputs, *carry)]
    d1.dsp_synthesis_host(*inputs, carry)
    for a, b in zip(saved, (*inputs, *carry)):
        assert torch.equal(a, b)


def test_vocoder_100_frames_equal_50_plus_50():
    g = np.random.default_rng(4)
    feats = torch.as_tensor(g.normal(size=(2, 100, 20)).astype(np.float32)
                            * 0.3)
    st = tdsp.dsp_vocoder_init(4, 2)
    whole, s_whole = tdsp.dsp_synthesize_frames(st, feats)
    p1, s1 = tdsp.dsp_synthesize_frames(st, feats[:, :50])
    p2, s2 = tdsp.dsp_synthesize_frames(s1, feats[:, 50:])
    assert torch.equal(torch.cat([p1, p2], dim=1), whole)
    for a, b in zip(s2[:3], s_whole[:3]):
        assert torch.equal(a, b)
    assert float(whole.abs().max()) > 0


def test_host_loop_matches_the_jax_scan():
    """65 frames of one stream in two calls, the JAX vocoder's noise
    injected, held to the JAX scan as tests/test_torch_dsp.py holds the
    plain loop."""
    T, split, seed = 65, 35, 3
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(T, 20)).astype(np.float32) * 0.3
    feats[:, 0] -= 2.0
    feats[:, 18] = rng.uniform(-1.36, 3.12, size=T)
    feats[:, 19] = np.where(np.arange(T) % 20 < 12, rng.uniform(0, .5, T),
                            rng.uniform(-0.5, -0.2, T))
    key, noise = jax.random.PRNGKey(seed), []
    for _ in range(T):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k, (160,), jnp.float32)))
    noise = np.stack(noise)
    js, ts = jdsp.dsp_vocoder_init(seed), tdsp.dsp_vocoder_init(seed)
    jp, tp = [], []
    before = d1.dsp_synthesis_host.launches
    for a, b in ((0, split), (split, T)):
        p, js = jdsp.dsp_synthesize_frames(js, jnp.asarray(feats[a:b]))
        jp.append(np.asarray(p))
        p, ts = tdsp.dsp_synthesize_frames(
            ts, torch.as_tensor(feats[a:b]),
            noise=torch.as_tensor(noise[a:b]))
        tp.append(p.numpy())
        assert int(ts.pitch_phase[0]) == int(js.pitch_phase)
    assert d1.dsp_synthesis_host.launches == before + 2
    jp, tp = np.concatenate(jp), np.concatenate(tp)
    assert np.abs(jp).max() > 0.1
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    to16 = lambda x: np.clip(x * 32767.0, -32768, 32767).astype(  # noqa: E731
        np.int16).astype(np.int32)
    assert np.abs(to16(tp) - to16(jp)).max() <= 1
    np.testing.assert_allclose(ts.sig_mem[0].numpy(), np.asarray(js.sig_mem),
                               atol=1e-5)
    np.testing.assert_allclose(float(ts.deemph_mem[0]), float(js.deemph_mem),
                               atol=1e-5)


def test_synthesis_queue_job_of_3600_frames_on_the_cpu(tmp_path):
    """One job as the decoder app queues it (a [3600, 20] feature dump):
    vocoded to 3600 x 160 samples in under 5 s."""
    rng = np.random.default_rng(7)
    feats = (rng.normal(size=(3600, 20)) * 0.3).astype(np.float32)
    feats[:, 0] -= 2.0
    path = tmp_path / "job.npy"
    np.save(path, feats)
    inputs, carry = _loop_inputs(1, 1, 0)
    d1.dsp_synthesis_host(*inputs, carry)  # build outside the clock
    q = AsynchronousSynthesisQueue(device="cpu")
    before = d1.dsp_synthesis_host.launches
    t0 = time.perf_counter()
    q.add_job(str(path))
    q.wait()
    elapsed = time.perf_counter() - t0
    from scipy.io.wavfile import read
    fs, wav = read(tmp_path / "job.wav")
    assert fs == 16000 and wav.shape == (3600 * 160,)
    assert d1.dsp_synthesis_host.launches == before + 1
    assert elapsed < 5.0, elapsed


@pytest.fixture
def unbuilt(tmp_path, monkeypatch):
    """The host library as if never built, building into ``tmp_path``."""
    monkeypatch.setattr(_host, "_lib", None)
    monkeypatch.setattr(_host, "BUILD_ROOT", tmp_path)
    plain_calls = []
    monkeypatch.setattr(d1, "dsp_synthesis_plain",
                        lambda *a: plain_calls.append(a))
    return plain_calls


def test_missing_host_compiler_raises(unbuilt, monkeypatch):
    monkeypatch.setattr(_host.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    inputs, carry = _loop_inputs(1, 3, 1)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        d1.dsp_synthesis(*inputs, carry)
    assert unbuilt == []


def test_failed_host_build_raises_with_the_command(unbuilt, monkeypatch):
    monkeypatch.setattr(_host, "CXX_FLAGS",
                        _host.CXX_FLAGS + ["-DDSS_NOT_A_FLAG", "-Wl,--nope"])
    inputs, carry = _loop_inputs(1, 3, 1)
    with pytest.raises(RuntimeError, match="dsp_synthesis_host.cpp"):
        d1.dsp_synthesis(*inputs, carry)
    assert unbuilt == []
