"""The frame-parallel form of the DSP vocoder's sample loop (kernel D1's
algorithm, ``ops/dsp_synthesis.py::dsp_synthesis_blocked_plain``) on the
CPU:

* against the serial loop (``dsp_synthesis_plain``, and the host-compiled
  ``dsp_synthesis_host`` bit for bit with it) at the JAX parity tolerance
  of tests/test_torch_dsp.py (float PCM atol 1e-5, int16 within 1 LSB,
  pitch phase exact, filter and de-emphasis memory atol 1e-5), on seeded
  features, resonant (high-Q) cepstra, periods above a frame, entering
  phases at or below zero, a period that changes every frame, T = 1 and
  B = 3;
* phase B's closed form (``next_phase``, the pulses of ``excitation``)
  against the per-sample rule, exactly;
* any split of the frames into calls equals one call bit for bit;
* with the JAX vocoder's noise injected, against
  ``dss_tpu.vocoder.dsp.dsp_synthesize_frames`` at the same tolerance;
* ``dsp_vocode`` on CPU tensors: its plain version (the eager frame-rate
  part and noise of vocoder/dsp.py, then the blocked form).

The card tests (tests/test_torch_cuda.py) hold the kernel to the blocked
form bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.vocoder import dsp as jdsp
from dss_tpu_torch.ops import dsp_synthesis as d1
from dss_tpu_torch.vocoder import dsp as tdsp
from dss_tpu_torch.vocoder.lpc import DCT_MATRIX

torch.set_num_threads(1)


def _features(batch, frames, seed, case="seeded"):
    """Seeded vocoder features [batch, frames, 20] of one of the cases."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, frames, 20)).astype(np.float32) * 0.3
    feats[..., 0] -= 2.0
    feats[..., 18] = rng.uniform(-1.36, 3.12, size=(batch, frames))
    feats[..., 19] = np.where(rng.random((batch, frames)) < 0.6,
                              rng.uniform(0.0, 0.5, (batch, frames)),
                              rng.uniform(-0.5, -0.2, (batch, frames)))
    if case == "resonant":
        # A 40 dB peak in band 5 over a flat envelope: poles at radius
        # ~0.99, where a one-ulp change of the taps moves the PCM by ~1e-6.
        log_e = np.full(18, -2.0)
        log_e[5] += 4.0
        feats[..., :18] = (DCT_MATRIX @ log_e).astype(np.float32) \
            + 0.01 * feats[..., :18]
    elif case == "long_periods":   # 161-256 samples: frames without a pulse
        feats[..., 18] = rng.uniform(1.22, 3.12, size=(batch, frames))
        feats[..., 19] = rng.uniform(0.2, 0.5, size=(batch, frames))
    elif case == "changing_period":  # every frame's period differs
        feats[..., 18] = np.where(np.arange(frames) % 2 == 0, -1.36, 2.5) \
            + 0.02 * np.arange(frames)
        feats[..., 19] = 0.45
    return torch.as_tensor(feats)


def _inputs(batch, frames, seed, case="seeded", phase=None):
    """Sample-loop inputs: the eager frame-rate part of ``_features``,
    Gaussian noise and a nonzero carried state."""
    rng = np.random.default_rng(seed + 1)
    params = tdsp.frame_parameters(_features(batch, frames, seed, case))
    noise = torch.as_tensor(rng.normal(size=(batch, frames, 160))
                            .astype(np.float32))
    if phase is None:
        phase = rng.integers(-3, 200, batch)
    carry = d1.DspCarry(
        torch.as_tensor(rng.normal(size=(batch, 16)).astype(np.float32)) * .1,
        torch.as_tensor(np.asarray(phase, np.int32)),
        torch.as_tensor(rng.normal(size=batch).astype(np.float32)) * 0.1)
    return (*params, noise), carry


def _to16(x):
    return np.clip(x.numpy() * 32767.0, -32768, 32767).astype(
        np.int16).astype(np.int32)


def _assert_close(pcm, carry, want, want_carry):
    """The JAX parity tolerance of tests/test_torch_dsp.py."""
    np.testing.assert_allclose(pcm.numpy(), want.numpy(), atol=1e-5)
    assert np.abs(_to16(pcm) - _to16(want)).max() <= 1
    assert torch.equal(carry.pitch_phase, want_carry.pitch_phase)
    np.testing.assert_allclose(carry.sig_mem.numpy(),
                               want_carry.sig_mem.numpy(), atol=1e-5)
    np.testing.assert_allclose(carry.deemph_mem.numpy(),
                               want_carry.deemph_mem.numpy(), atol=1e-5)


CASES = {
    "seeded": dict(batch=1, frames=120, case="seeded"),
    "resonant": dict(batch=1, frames=80, case="resonant"),
    "long_periods": dict(batch=2, frames=40, case="long_periods"),
    "phase_at_or_below_zero": dict(batch=3, frames=30, case="seeded",
                                   phase=[0, -1, -7]),
    "changing_period": dict(batch=1, frames=60, case="changing_period"),
    "one_frame": dict(batch=2, frames=1, case="seeded"),
    "three_streams": dict(batch=3, frames=25, case="seeded"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_blocked_form_matches_the_serial_loop(name):
    kw = dict(CASES[name])
    inputs, carry = _inputs(kw.pop("batch"), kw.pop("frames"), 12, **kw)
    pcm, out = d1.dsp_synthesis_blocked_plain(*inputs, carry)
    want, want_out = d1.dsp_synthesis_plain(*inputs, carry)
    host, host_out = d1.dsp_synthesis_host(*inputs, carry)
    assert torch.equal(host, want)
    assert pcm.shape == want.shape and float(want.abs().max()) > 0.01
    _assert_close(pcm, out, want, want_out)
    _assert_close(pcm, out, host, host_out)
    if name == "long_periods":
        assert int(inputs[4].min()) > 160
    if name == "resonant":  # the case is resonant: poles near the circle
        a = inputs[0][0, 0].double().numpy()
        assert np.abs(np.roots(np.concatenate([[1.0], a]))).max() > 0.99


def _serial_phase(phase, period):
    """The per-sample rule over one frame: (pulse positions, phase after)."""
    pulses = []
    for i in range(160):
        if phase <= 0:
            pulses.append(i)
            phase = period
        phase -= 1
    return pulses, phase


def test_phase_closed_form_matches_the_per_sample_rule():
    """``next_phase`` and the pulses of ``excitation`` equal the per-sample
    rule exactly for entering phases -300..400 and periods 32..256 (unit
    pulses: gain 1, v_mix 1, voiced, no noise, so the excitation is
    sqrt(period) at the pulses and 0 elsewhere)."""
    phases = np.arange(-300, 401, 7, dtype=np.int32)
    periods = np.array([32, 33, 80, 159, 160, 161, 200, 255, 256], np.int32)
    ph, per = (torch.as_tensor(a) for a in np.meshgrid(phases, periods))
    got = d1.next_phase(ph, per)
    e = d1.excitation(torch.ones(ph.shape), torch.ones(ph.shape),
                      torch.ones(ph.shape, dtype=torch.bool), per,
                      torch.zeros(ph.shape + (160,)), ph)
    for idx in np.ndindex(ph.shape):
        pulses, after = _serial_phase(int(ph[idx]), int(per[idx]))
        assert int(got[idx]) == after
        mask = np.zeros(160, bool)
        mask[pulses] = True
        np.testing.assert_array_equal(e[idx].numpy() != 0, mask)
        np.testing.assert_array_equal(
            e[idx].numpy()[mask], np.float32(np.sqrt(np.float32(per[idx]))))


def test_entering_phases_follow_the_frames():
    """Phase B over 50 frames with a new period each frame equals the
    per-sample rule run across the frames."""
    rng = np.random.default_rng(3)
    period = torch.as_tensor(rng.integers(32, 257, (2, 50)).astype(np.int32))
    start = torch.tensor([-5, 300], dtype=torch.int32)
    got, after = d1.entering_phases(period, start)
    for b in range(2):
        p = int(start[b])
        for t in range(50):
            assert int(got[b, t]) == p
            p = _serial_phase(p, int(period[b, t]))[1]
        assert int(after[b]) == p


@pytest.mark.parametrize("splits", [(1, 29), (15, 15), (7, 11, 12)])
def test_blocked_form_chunked_equals_single_shot(splits):
    """Any split of 30 frames into calls gives the one call's PCM and
    state bit for bit (the state a call returns is the carry pass's)."""
    inputs, carry = _inputs(2, 30, 5)
    whole, c_whole = d1.dsp_synthesis_blocked_plain(*inputs, carry)
    parts, c, a = [], carry, 0
    for n in splits:
        p, c = d1.dsp_synthesis_blocked_plain(
            *(t[:, a:a + n] for t in inputs), c)
        parts.append(p)
        a += n
    assert torch.equal(torch.cat(parts, dim=1), whole)
    for x, y in zip(c, c_whole):
        assert torch.equal(x, y)


def _jax_noise(seed, frames):
    """The JAX vocoder's noise for its first ``frames`` frames."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(frames):
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(k, (160,), jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("seed, split", [(3, 35), (8, 21)])
def test_blocked_form_with_jax_noise_matches_jax(seed, split):
    """65 frames in two calls (split after ``split``), the port's eager
    frame-rate part and the JAX vocoder's noise through the blocked form,
    against dss_tpu's ``dsp_synthesize_frames``: float PCM atol 1e-5,
    int16 within 1 LSB, pitch phase exact after each call, filter and
    de-emphasis memory atol 1e-5."""
    T = 65
    feats = _features(1, T, seed)[0]
    noise = torch.as_tensor(_jax_noise(seed, T))
    js = jdsp.dsp_vocoder_init(seed)
    carry = d1.DspCarry(torch.zeros((1, 16)), torch.zeros(1, dtype=torch.int32),
                        torch.zeros(1))
    jp, tp = [], []
    for a, b in ((0, split), (split, T)):
        p, js = jdsp.dsp_synthesize_frames(js, jnp.asarray(feats[a:b].numpy()))
        jp.append(np.asarray(p))
        p, carry = d1.dsp_synthesis_blocked_plain(
            *tdsp.frame_parameters(feats[None, a:b]), noise[None, a:b], carry)
        tp.append(p[0].numpy())
        assert int(carry.pitch_phase[0]) == int(js.pitch_phase)
    jp, tp = np.concatenate(jp), np.concatenate(tp)
    assert tp.shape == (T * 160,) and np.abs(jp).max() > 0.1
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    assert np.abs(_to16(torch.as_tensor(tp))
                  - _to16(torch.as_tensor(jp))).max() <= 1
    np.testing.assert_allclose(carry.sig_mem[0].numpy(),
                               np.asarray(js.sig_mem), atol=1e-5)
    np.testing.assert_allclose(float(carry.deemph_mem[0]),
                               float(js.deemph_mem), atol=1e-5)


def test_dsp_vocode_on_the_cpu_is_its_plain_version():
    """``dsp_vocode`` on CPU tensors: the eager frame-rate part and the
    vocoder's keyed noise (returned with ``return_params``, bit for bit),
    the blocked form on them, within the tolerance of the vocoder's CPU
    path (the serial loop); a given noise replaces the keyed one; T = 0
    returns the state unchanged."""
    feats = _features(2, 20, 9)
    carry = d1.DspCarry(torch.zeros((2, 16)), torch.tensor([0, 5],
                                                           dtype=torch.int32),
                        torch.zeros(2))
    before = d1.dsp_vocode.launches
    pcm, out, params = d1.dsp_vocode(feats, carry, 4, 30, return_params=True)
    assert d1.dsp_vocode.launches == before  # no kernel on the CPU
    want_params = (*tdsp.frame_parameters(feats),
                   tdsp.gaussian_noise(4, 2, 30, 20, "cpu"))
    for a, b in zip(params, want_params):
        assert a.dtype == b.dtype and torch.equal(a, b)
    blocked, c_blocked = d1.dsp_synthesis_blocked_plain(*want_params, carry)
    assert torch.equal(pcm, blocked)
    state = tdsp.DspVocoderState(*carry, seed=4, frame_ctr=30)
    serial, s_state = tdsp.dsp_synthesize_frames(state, feats)
    _assert_close(pcm, out, serial, d1.DspCarry(*s_state[:3]))
    noise = torch.zeros((2, 20, 160))
    quiet, _ = d1.dsp_vocode(feats, carry, 4, 30, noise=noise)
    assert not torch.equal(quiet, pcm)
    empty, same = d1.dsp_vocode(feats[:, :0], carry, 4, 30)
    assert empty.shape == (2, 0)
    for a, b in zip(same, carry):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        d1.dsp_vocode(feats[..., :18], carry, 4, 30)
