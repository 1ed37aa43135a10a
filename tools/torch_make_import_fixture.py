"""Build an upstream-shaped LPCNet import fixture for the port (counterpart
of tools/make_import_fixture.py).

``foreign_datasets`` builds, from a seed with numpy, the datasets of a
Keras-layout LPCNet checkpoint at the released xiph sizes (GRU-A 384,
GRU-B 16, embedding and conditioning 128, pitch embedding 64, MDense head
with per-channel inner biases: the feature set
``vocoder/interop.py::params_from_datasets`` maps), as the dict that
``interop.read_datasets`` returns for the file.  By default its arrays are
the JAX tool's, draw for draw; ``tame=True`` gives the scaled network of
tests/torch_xiph.py (unit-variance pre-activations, recurrent gain 0.5),
whose greedy sampling does not sit on near-ties.  ``write_feature_file``
encodes 3 s of synthetic speech-like audio with the port's encoder into the
36-column ``.f32`` format (``lpcnet_demo -features``)::

    python tools/torch_make_import_fixture.py --out-dir DIR [--device cpu]
    python tools/torch_vocoder_ab.py DIR/feats.f32 --h5 DIR/xiph_like.h5 --rtf

The ``.h5`` file is written only where h5py imports; elsewhere the tool
says so, and ``tools/torch_vocoder_ab.py``'s
``main(argv, datasets=...)`` takes the datasets in memory.  Weights are
random: what the fixture exercises is the layer map and the sampler
kernel's path and speed at the released widths, which depend only on the
shapes.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dss_tpu_torch.device import resolve_device  # noqa: E402
from dss_tpu_torch.vocoder import interop  # noqa: E402
from dss_tpu_torch.vocoder.features import LPCFeatureEncoder  # noqa: E402

NB_TOTAL_FEATURES = 36  # columns of an lpcnet_demo .f32 feature dump


def foreign_datasets(seed: int = 0, gru_a: int = 384, gru_b: int = 16,
                     cond: int = 128, embed: int = 128, pitch_dim: int = 64,
                     tame: bool = False) -> interop.Datasets:
    """{``model_weights/<layer>/<layer>/<kind>:0``: float32 array}: each
    array a draw of standard normals, in the JAX tool's layer order, times
    0.15 (the JAX tool's fixture) or, with ``tame``, scaled by its fan-in
    and gain (tests/torch_xiph.py)."""
    rng = np.random.default_rng(seed)
    ds: interop.Datasets = {}

    def put(layer, kind, shape, fan_in=None, gain=1.0, s=0.3, offset=None):
        x = rng.normal(size=shape)
        if not tame:
            arr = (x * 0.15).astype(np.float32)
        elif fan_in is not None:
            arr = (x * gain / np.sqrt(fan_in)).astype(np.float32)
        else:
            arr = (x * s).astype(np.float32)
            if offset is not None:
                arr = offset + arr
        ds[f"model_weights/{layer}/{layer}/{kind}:0"] = arr

    x_in = 3 * embed + cond
    put("embed_sig", "embeddings", (256, embed), s=1.0)
    put("embed_pitch", "embeddings", (256, pitch_dim), s=1.0)
    put("feature_conv1", "kernel", (3, 20 + pitch_dim, cond),
        fan_in=3 * (20 + pitch_dim))
    put("feature_conv1", "bias", (cond,), s=0.1)
    put("feature_conv2", "kernel", (3, cond, cond), fan_in=3 * cond)
    put("feature_conv2", "bias", (cond,), s=0.1)
    put("feature_dense1", "kernel", (cond, cond), fan_in=cond)
    put("feature_dense1", "bias", (cond,), s=0.1)
    put("feature_dense2", "kernel", (cond, cond), fan_in=cond)
    put("feature_dense2", "bias", (cond,), s=0.1)
    put("gru_a", "kernel", (x_in, 3 * gru_a), fan_in=x_in)
    put("gru_a", "recurrent_kernel", (gru_a, 3 * gru_a), fan_in=gru_a,
        gain=0.5)
    put("gru_a", "bias", (2, 3 * gru_a), s=0.1)
    put("gru_b", "kernel", (gru_a + cond, 3 * gru_b), fan_in=gru_a + cond)
    put("gru_b", "recurrent_kernel", (gru_b, 3 * gru_b), fan_in=gru_b,
        gain=0.5)
    put("gru_b", "bias", (2, 3 * gru_b), s=0.1)
    put("dual_fc", "kernel", (gru_b, 256, 2), fan_in=gru_b, gain=2.0)
    put("dual_fc", "bias", (256, 2), s=0.5)         # inner (pre-tanh) biases
    put("dual_fc", "factor", (256, 2), s=0.5, offset=1.0)
    return ds


def speech_like_pcm(seconds: float = 3.0, seed: int = 1) -> np.ndarray:
    """The JAX tool's test signal: a gliding two-harmonic tone with noise,
    int16 at 16 kHz."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000.0
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = np.cumsum(2 * np.pi * f0 / 16000.0)
    sig = (0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase)
           + 0.05 * rng.normal(size=n)).astype(np.float32)
    return np.clip(sig * 12000.0, -32768, 32767).astype(np.int16)


def write_feature_file(path: str, seconds: float = 3.0, seed: int = 1,
                       device=None) -> np.ndarray:
    """Encode ``speech_like_pcm`` into the 36-column .f32 format (columns
    0-17 Bark cepstrum, 18-19 pitch period / correlation: the 20 the
    vocoder reads; the rest zeros) and return the [N, 20] features."""
    feats = LPCFeatureEncoder(device=device).compute_LPC_features(
        speech_like_pcm(seconds, seed))
    full = np.zeros((feats.shape[0], NB_TOTAL_FEATURES), np.float32)
    full[:, :20] = feats
    full.tofile(path)
    return feats


def main(argv=None) -> interop.Datasets:
    """Writes the fixture under ``--out-dir`` and returns its datasets."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=os.path.join(
        tempfile.gettempdir(), "import_fixture"))
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--device", default=None,
                        help="Torch device of the feature encoder "
                             "(default: cuda).")
    args = parser.parse_args(argv)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    datasets = foreign_datasets()
    params, model = interop.params_from_datasets(datasets)
    assert "fc_out1_b" in params and "emb_pitch" in params
    h5 = out / "xiph_like.h5"
    try:
        interop.write_datasets(datasets, str(h5))
        print(f"wrote {h5} (gru_a={model.gru_a_units} "
              f"gru_b={model.gru_b_units}, MDense inner biases + pitch "
              f"embedding)")
    except ImportError:
        print(f"h5py is not installed: {h5} not written; "
              f"foreign_datasets() gives its datasets in memory")
    f32 = out / "feats.f32"
    feats = write_feature_file(str(f32), args.seconds,
                               device=resolve_device(args.device))
    print(f"wrote {f32} ({len(feats)} frames, {len(feats) * 0.01:.2f} s)")
    return datasets


if __name__ == "__main__":
    main()
