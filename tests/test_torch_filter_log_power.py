"""The port's fused packet front end (dss_tpu_torch/ops/filter_log_power.py:
IIR cascade + warm-start framing + log power in one call) on the CPU: its
plain version against the eager composition it replaces, the front end
through it against the JAX package, and the wrapper's rules.

Inputs come from numpy seeds; only numpy crosses between the packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.ops import HighGammaExtractor as JHGA
from dss_tpu.ops.car import CommonAverageReferencing as JCAR
from dss_tpu.ops.car import ZScoreNormalization as JZ
from dss_tpu.utils import channels as jch
from dss_tpu_torch.ops import _cuda
from dss_tpu_torch.ops import filter_log_power as flp
from dss_tpu_torch.ops import hga as thga
from dss_tpu_torch.ops.car import CommonAverageReferencing, \
    ZScoreNormalization
from dss_tpu_torch.ops.filters import sosfilt_scan
from dss_tpu_torch.ops.frames import framer_step, log_power_frames
from dss_tpu_torch.ops.hga import HighGammaExtractor
from dss_tpu_torch.utils import channels as tch

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _state(C, seed=0):
    """The deployed cascade (sos [16, 6]) and a random state at width C."""
    ex = HighGammaExtractor(fs=1000, nb_electrodes=C, device="cpu")
    rng = np.random.default_rng(seed)
    zi = _t(ex._zi0) + _t(rng.normal(size=ex._zi0.shape) * 0.1)
    return ex.sos, zi


# (T, R): a packet with the steady carry, coalesced packets, a packet shorter
# than the overlap, a short first packet zero-padded to one frame, an offline
# first block (R = 0), and blocks too short for any window (W = 0).
CASES = [(40, 40), (80, 40), (160, 40), (320, 40), (10, 40), (30, 20),
         (300, 0), (5, 40), (42, 0)]


@pytest.mark.parametrize("T, R", CASES)
def test_plain_equals_eager_composition(T, R):
    """filter_log_power_plain is exactly sosfilt_scan, the carried rows put
    first, and log_power_frames over the block (bit for bit)."""
    sos, zi = _state(6, seed=T)
    rng = np.random.default_rng(T + R)
    x, carry = _t(rng.normal(size=(T, 6))), _t(rng.normal(size=(R, 6)))
    feats, zf, carry_out = flp.filter_log_power_plain(sos, x, zi, carry, 10,
                                                      50)
    y, zf_want = sosfilt_scan(sos, x, zi)
    block = torch.cat([carry, y])
    want = log_power_frames(block, 1000, 0.05, 0.01)
    assert feats.shape == want.shape == ((R + T - 50) // 10 + 1
                                         if R + T >= 50 else 0, 6)
    assert torch.equal(feats, want)
    assert torch.equal(zf, zf_want)
    assert torch.equal(carry_out, block[-40:])
    if R == 40:  # the steady state is framer_step's
        assert torch.equal(carry_out, framer_step(carry, y)[1])


def _transforms(pkg):
    """The deployed pre/post transform chain built from either package."""
    ch = jch if pkg == "jax" else tch
    car_cls, z_cls = (JCAR, JZ) if pkg == "jax" else \
        (CommonAverageReferencing, ZScoreNormalization)
    rng = np.random.default_rng(3)
    means = rng.normal(size=(1, 64)).astype(np.float32) * 0.1
    stds = (1.0 + rng.random(size=(1, 64))).astype(np.float32)
    pre = [ch.SelectElectrodesFromBothGrids(),
           car_cls(exclude_channels=[19, 38, 48, 52],
                   grids=[ch.speech_grid(), ch.motor_grid()],
                   layout=ch.default_layout()),
           ch.SelectElectrodesOverSpeechAreas()]
    return pre, [z_cls(means, stds)]


def _extractors():
    pre_j, post_j = _transforms("jax")
    pre_t, post_t = _transforms("torch")
    return (JHGA(fs=1000, nb_electrodes=64, pre_transforms=pre_j,
                 post_transforms=post_j),
            HighGammaExtractor(fs=1000, nb_electrodes=64, pre_transforms=pre_t,
                               post_transforms=post_t, device="cpu"))


@pytest.mark.parametrize("packets", [1, 2, 4, 8])
def test_packet_step_matches_jax(packets, monkeypatch):
    """The deployed chain (129 raw -> 64 channels) fed as single packets and
    as coalesced calls of 2, 4 and 8 packets: the port's packet_step, which
    goes through filter_log_power (the eager cascade of hga is never
    called), equals the JAX packet_step on the same calls, the first call's
    warm-up frames dropped.  atol 1e-4: log power of IIR output after 16
    sections and z-scoring, f32 on both sides (test_torch_frontend.py)."""
    def no_eager(*args):
        raise AssertionError("packet_step ran the eager cascade")
    monkeypatch.setattr(thga, "sosfilt_scan", no_eager)
    raw = np.random.default_rng(packets).normal(
        size=(640, 129)).astype(np.float32)
    jx, tx = _extractors()
    js, ts = jx.init_state(), tx.init_state()
    step = 40 * packets
    jf, tf = [], []
    for k in range(0, len(raw), step):
        f_j, js = jx.packet_step(js, jnp.asarray(raw[k:k + step]))
        f_t, ts = tx.packet_step(ts, _t(raw[k:k + step]))
        jf.append(np.asarray(f_j))
        tf.append(f_t.numpy())
    w = tx.warmup_frames(step)
    assert w == jx.warmup_frames(step)
    got, want = np.concatenate(tf)[w:], np.concatenate(jf)[w:]
    assert got.shape == want.shape == ((640 - 50) // 10 + 1 + (step < 50), 64)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(ts.zi.numpy(), np.asarray(js.zi), atol=1e-5)
    np.testing.assert_allclose(ts.remainder.numpy(), np.asarray(js.remainder),
                               atol=1e-5)


@pytest.mark.parametrize("blocks", [
    [300, 40, 40],            # a long first block (R = 0), then packets
    [30, 40, 40, 120],        # a short first packet zero-padded to one frame
    [40, 40, 10, 5, 80],      # packets shorter than the overlap, one W = 0
])
def test_extract_features_matches_jax(blocks):
    """The reference-style stateful extract_features, now through
    filter_log_power with the framer's carry (no host round trip of the
    filtered signal), against the JAX extract_features block by block.
    atol 1e-4 as above."""
    raw = np.random.default_rng(len(blocks)).normal(
        size=(sum(blocks), 129)).astype(np.float32)
    jx, tx = _extractors()
    k = 0
    for n in blocks:
        want = jx.extract_features(raw[k:k + n])
        got = tx.extract_features(raw[k:k + n])
        k += n
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(tx.zi.numpy(), np.asarray(jx.zi), atol=1e-5)
    np.testing.assert_allclose(tx.framebuffer.remainder.numpy(),
                               np.asarray(jx.framebuffer.remainder), atol=1e-5)


def test_framer_carry_equals_insert():
    """StreamingFramer.carry gives the rows insert puts before each block:
    none for a long first block, zeros for a short one, the remainder
    after."""
    from dss_tpu_torch.ops.frames import StreamingFramer
    rng = np.random.default_rng(1)
    for first in (30, 60):
        a = StreamingFramer(0.05, 0.01, 1000, 3)
        b = StreamingFramer(0.05, 0.01, 1000, 3)
        for n in (first, 40, 10):
            data = rng.normal(size=(n, 3)).astype(np.float32)
            block = a.insert(data)
            carry = b.carry(n, torch.zeros(1, 3))
            assert carry.dtype == torch.float32
            np.testing.assert_array_equal(
                torch.cat([carry, _t(data)]).numpy(), block)
            b.remainder = torch.cat([carry, _t(data)])[-b.overlap:]


def test_other_geometry_keeps_the_eager_path():
    """A geometry whose hop does not divide the window (12 ms at a 5 ms hop)
    is not taken by filter_log_power: packet_step runs the eager cascade and
    the gather form, and still matches JAX."""
    raw = np.random.default_rng(4).normal(size=(200, 6)).astype(np.float32)
    jx = JHGA(fs=1000, nb_electrodes=6, window_length=0.012,
              window_shift=0.005)
    tx = HighGammaExtractor(fs=1000, nb_electrodes=6, window_length=0.012,
                            window_shift=0.005, device="cpu")
    assert tx._uniform is None
    assert HighGammaExtractor(fs=1000, nb_electrodes=6,
                              device="cpu")._uniform == (10, 50)
    before = flp.filter_log_power.launches
    js, ts = jx.init_state(), tx.init_state()
    for k in range(0, 200, 40):
        f_j, js = jx.packet_step(js, jnp.asarray(raw[k:k + 40]))
        f_t, ts = tx.packet_step(ts, _t(raw[k:k + 40]))
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-4)
    assert flp.filter_log_power.launches == before


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    """CPU tensors take the plain version without loading the kernel
    library, and count no launch."""
    def no_library(*args, **kwargs):
        raise AssertionError("the CPU path loaded the CUDA library")
    monkeypatch.setattr(_cuda, "library", no_library)
    sos, zi = _state(4)
    rng = np.random.default_rng(5)
    x, carry = _t(rng.normal(size=(40, 4))), _t(rng.normal(size=(40, 4)))
    before = flp.filter_log_power.launches
    got = flp.filter_log_power(sos, x, zi, carry, 10, 50)
    want = flp.filter_log_power_plain(sos, x, zi, carry, 10, 50)
    assert flp.filter_log_power.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what", [
    "x_f64", "zi_f64", "carry_f16", "zi_shape", "sos_shape", "carry_width",
    "too_short", "hop", "empty_x", "carry_rows"])
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    """Non-float32 inputs raise TypeError; mis-shaped state, a block with
    fewer rows than it must carry out, a hop that does not divide the window,
    an empty packet and more carried rows than the kernel stages raise
    ValueError — on the CPU as on the card."""
    sos, zi = _state(4)
    x, carry = torch.zeros(40, 4), torch.zeros(40, 4)
    hop, length = 10, 50
    err = ValueError
    if what == "x_f64":
        x, err = x.double(), TypeError
    elif what == "zi_f64":
        zi, err = zi.double(), TypeError
    elif what == "carry_f16":
        carry, err = carry.half(), TypeError
    elif what == "zi_shape":
        zi = zi[:, :, :3]
    elif what == "sos_shape":
        sos = sos[:, :5]
    elif what == "carry_width":
        carry = torch.zeros(40, 5)
    elif what == "too_short":
        x, carry = torch.zeros(10, 4), torch.zeros(20, 4)
    elif what == "hop":
        hop = 15
    elif what == "empty_x":
        x = torch.zeros(0, 4)
    elif what == "carry_rows":
        carry = torch.zeros(flp.MAX_CARRY + 1, 4)
    with pytest.raises(err):
        flp.filter_log_power(sos, x, zi, carry, hop, length)
