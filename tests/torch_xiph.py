"""A synthetic LPCNet checkpoint in the xiph Keras layout, built from a seed
with numpy: the datasets of its .h5 file keyed by path, as
``dss_tpu_torch.vocoder.interop.read_datasets`` returns them.  The
released model's widths by default (GRU-A 384, dense; GRU-B 16; embedding
and conditioning 128; pitch embedding 64), so
``interop.params_from_datasets`` gives a model with the MDense inner
biases, the pitch-embedding frame net and a GRU-A too large to stay
resident in the sampler kernel.

The scales keep the network tame, as a trained one is: unit-variance
pre-activations, recurrent matrices of gain 0.5, and output heads whose
logits spread over a few units, so greedy sampling does not sit on
near-ties."""

import numpy as np

RELEASED = dict(gru_a=384, gru_b=16, cond=128, embed=128, pitch=64)


def xiph_datasets(seed, gru_a=384, gru_b=16, cond=128, embed=128, pitch=64):
    """{``model_weights/<layer>/<layer>/<kind>:0``: float32 array}."""
    rng = np.random.default_rng(seed)

    def w(fan_in, *shape, gain=1.0):
        return (rng.normal(size=shape) * gain / np.sqrt(fan_in)).astype(
            np.float32)

    def n(*shape, s=0.3):
        return (rng.normal(size=shape) * s).astype(np.float32)

    ds = {}

    def put(layer, kind, arr):
        ds[f"model_weights/{layer}/{layer}/{kind}:0"] = arr

    x_in = 3 * embed + cond
    put("embed_sig", "embeddings", n(256, embed, s=1.0))
    put("embed_pitch", "embeddings", n(256, pitch, s=1.0))
    put("feature_conv1", "kernel", w(3 * (20 + pitch), 3, 20 + pitch, cond))
    put("feature_conv1", "bias", n(cond, s=0.1))
    put("feature_conv2", "kernel", w(3 * cond, 3, cond, cond))
    put("feature_conv2", "bias", n(cond, s=0.1))
    put("feature_dense1", "kernel", w(cond, cond, cond))
    put("feature_dense1", "bias", n(cond, s=0.1))
    put("feature_dense2", "kernel", w(cond, cond, cond))
    put("feature_dense2", "bias", n(cond, s=0.1))
    put("gru_a", "kernel", w(x_in, x_in, 3 * gru_a))
    put("gru_a", "recurrent_kernel", w(gru_a, gru_a, 3 * gru_a, gain=0.5))
    put("gru_a", "bias", n(2, 3 * gru_a, s=0.1))
    put("gru_b", "kernel", w(gru_a + cond, gru_a + cond, 3 * gru_b))
    put("gru_b", "recurrent_kernel", w(gru_b, gru_b, 3 * gru_b, gain=0.5))
    put("gru_b", "bias", n(2, 3 * gru_b, s=0.1))
    put("dual_fc", "kernel", w(gru_b, gru_b, 256, 2, gain=2.0))
    put("dual_fc", "bias", n(256, 2, s=0.5))
    put("dual_fc", "factor", (1.0 + n(256, 2, s=0.5)))
    return ds
