"""A synthetic LPCNet checkpoint in the xiph Keras layout, built from a seed
with numpy: the datasets of its .h5 file keyed by path, as
``dss_tpu_torch.vocoder.interop.read_datasets`` returns them.  The
released model's widths by default (GRU-A 384, dense; GRU-B 16; embedding
and conditioning 128; pitch embedding 64), so
``interop.params_from_datasets`` gives a model with the MDense inner
biases, the pitch-embedding frame net and a GRU-A too large to stay
resident in the sampler kernel.

The datasets come from tools/torch_make_import_fixture.py's
``foreign_datasets`` with ``tame=True``: the scales keep the network tame,
as a trained one is
(unit-variance pre-activations, recurrent matrices of gain 0.5, and output
heads whose logits spread over a few units), so greedy sampling does not
sit on near-ties."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

from torch_make_import_fixture import foreign_datasets  # noqa: E402

RELEASED = dict(gru_a=384, gru_b=16, cond=128, embed=128, pitch=64)


def xiph_datasets(seed, gru_a=384, gru_b=16, cond=128, embed=128, pitch=64):
    """{``model_weights/<layer>/<layer>/<kind>:0``: float32 array}."""
    return foreign_datasets(seed, gru_a, gru_b, cond, embed, pitch,
                            tame=True)
