"""The JAX package's parallel front-end cascade (dss_tpu/ops/filters.py
``sosfilt_parallel`` and ``HighGammaExtractor(parallel_filter=True)``)
against the port's cascade, on the CPU, with the deployed 16-section
cascade (70-170 Hz band-pass, 118-122 Hz band-stop) and its nonzero initial
state.

The port runs the cascade through the front-end kernel at every block
length (here its plain versions: ``sosfilt_scan`` for the cascade,
``filter_log_power`` for the features) and refuses ``parallel_filter=True``.
These tests hold that the kernel's cascade gives what the JAX package's
parallel cascade gives, below one of its 512-sample blocks, at a whole
number of them, and with a remainder: y and zf atol 2e-5 (the JAX
package's own parallel-vs-sequential tolerance), log-power features atol
1e-4.
"""

import numpy as np
import pytest
import torch

from dss_tpu.ops import filters as jfilters
from dss_tpu.ops.hga import HighGammaExtractor as JHGA
from dss_tpu_torch.ops import filters as tfilters
from dss_tpu_torch.ops import hga as thga

torch.set_num_threads(1)
FS = 1000


def _cascade(C):
    bp = jfilters.design_bandpass(FS, 70, 170)
    bs = jfilters.design_bandstop(FS, 118, 122)
    zi = np.concatenate([jfilters.sosfilt_zi(bp, C),
                         jfilters.sosfilt_zi(bs, C)]).astype(np.float32)
    return np.concatenate([bp, bs]), zi


def _scan(sos, x, zi):
    return tfilters.sosfilt_scan(torch.as_tensor(sos, dtype=torch.float32),
                                 torch.as_tensor(x), torch.as_tensor(zi))


@pytest.mark.parametrize("T", [333, 1024, 3 * 512 + 77])
def test_cascade_matches_jax_parallel_cascade(T):
    """Below one block, a whole number of blocks, and blocks plus a
    remainder: y and zf of the port's cascade against the JAX package's
    parallel cascade (atol 2e-5)."""
    C = 6
    sos, zi = _cascade(C)
    x = np.random.default_rng(T).normal(size=(T, C)).astype(np.float32)
    y_j, zf_j = jfilters.sosfilt_parallel(sos, x, zi)
    y_t, zf_t = _scan(sos, x, zi)
    assert sos.shape == (16, 6) and y_t.shape == (T, C)
    assert zf_t.shape == (16, 2, C)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5)
    np.testing.assert_allclose(zf_t.numpy(), np.asarray(zf_j), atol=2e-5)


def test_cascade_carries_state_like_jax_parallel():
    """Two calls with the carried state (700 + 600 samples) give the JAX
    parallel cascade's two calls, y and zf within atol 2e-5."""
    C = 4
    sos, zi = _cascade(C)
    x = np.random.default_rng(1).normal(size=(1300, C)).astype(np.float32)
    y1_j, z1_j = jfilters.sosfilt_parallel(sos, x[:700], zi)
    y2_j, z2_j = jfilters.sosfilt_parallel(sos, x[700:], z1_j)
    y1, z1 = _scan(sos, x[:700], zi)
    y2, z2 = tfilters.sosfilt_scan(torch.as_tensor(sos, dtype=torch.float32),
                                   torch.as_tensor(x[700:]), z1)
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(),
                               np.concatenate([y1_j, y2_j]), atol=2e-5)
    np.testing.assert_allclose(z2.numpy(), np.asarray(z2_j), atol=2e-5)


def test_extractor_matches_jax_parallel_extractor(monkeypatch):
    """The port's extractor on a first block of 800 samples and a second of
    400 (carried filter state and framer rows) gives the features of the
    JAX extractor with parallel_filter=True (atol 1e-4), each block through
    one call of the front-end kernel's wrapper."""
    C = 8
    data = np.random.default_rng(3).normal(size=(1200, C))
    jx = JHGA(fs=FS, nb_electrodes=C, parallel_filter=True)
    tx = thga.HighGammaExtractor(fs=FS, nb_electrodes=C, device="cpu")
    calls = []
    kernel = thga.filter_log_power

    def counted(sos, x, *args):
        calls.append(x.shape[0])
        return kernel(sos, x, *args)

    monkeypatch.setattr(thga, "filter_log_power", counted)
    for block in (data[:800], data[800:]):
        np.testing.assert_allclose(tx.extract_features(block),
                                   jx.extract_features(block), atol=1e-4)
    assert calls == [800, 400]


def test_parallel_filter_is_refused():
    """parallel_filter=True raises rather than run another cascade;
    parallel_filter=False is the default extractor, feature for feature."""
    with pytest.raises(ValueError, match="parallel_filter"):
        thga.HighGammaExtractor(fs=FS, nb_electrodes=4, device="cpu",
                                parallel_filter=True)
    data = np.random.default_rng(4).normal(size=(600, 4))
    off = thga.HighGammaExtractor(fs=FS, nb_electrodes=4, device="cpu",
                                  parallel_filter=False)
    default = thga.HighGammaExtractor(fs=FS, nb_electrodes=4, device="cpu")
    np.testing.assert_array_equal(off.extract_features(data),
                                  default.extract_features(data))
