"""Synthesize audio from stored vocoder features (.npy / .f32).

    python -m dss_tpu_torch.apps.synthesize FEATS OUT.wav
        [--backend dsp|net] [--weights W.npz] [--bunch 4] [--device cpu]

Counterpart of apps/synthesize.py: feed it a 20-dim feature matrix
(``.npy`` [T, >=20], or an LPCNet ``.f32`` dump of 36 features per frame)
and get a 16 kHz wav through the DSP vocoder (the default, as in the JAX
CLI) or the neural one.  Runs on the card unless ``--device cpu``.
"""

import argparse
import logging
from typing import Optional, Sequence

import numpy as np

from ..utils.audio import write_wav
from ..vocoder import LPCFeatureFile, LPCNet, packaged_weights, \
    packaged_weights_bunched

logger = logging.getLogger("synthesize.py")


def load_features(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        feats = np.load(path).astype(np.float32)
    elif path.endswith(".f32"):
        feats = np.stack(list(LPCFeatureFile(path))).astype(np.float32)
    else:
        raise SystemExit(f"Unsupported feature file: {path} (.npy or .f32)")
    if feats.ndim != 2 or feats.shape[1] < 20:
        raise SystemExit(f"Expected [frames, >=20] features, got {feats.shape}")
    return feats[:, :20]


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Vocode 20-dim acoustic features into a 16 kHz wav.")
    parser.add_argument("features",
                        help="Feature file (.npy [T,20] or LPCNet .f32).")
    parser.add_argument("out_wav", help="Output wav path.")
    parser.add_argument("--backend", default="dsp", choices=["dsp", "net"],
                        help="Vocoder backend: dsp (weight-free "
                             "source-filter) or net (neural).")
    parser.add_argument("--weights", default=None,
                        help="Neural vocoder weights (.npz) for --backend "
                             "net; default: the packaged checkpoint (see "
                             "--bunch).")
    parser.add_argument("--bunch", type=int, default=1,
                        help="--backend net without --weights: pick the "
                             "packaged checkpoint with this many samples "
                             "per network step (1, 2, 4 or 8).")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu.")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    feats = load_features(args.features)
    weights = args.weights
    if args.backend == "net" and not weights:
        weights = packaged_weights() if args.bunch == 1 \
            else packaged_weights_bunched(args.bunch)
        if weights is None:
            raise SystemExit(f"No packaged checkpoint for --bunch "
                             f"{args.bunch}")
    vocoder = LPCNet(backend=args.backend, weights=weights,
                     device=args.device)
    pcm = vocoder.synthesize_frames(feats)
    write_wav(args.out_wav, pcm, fs=16000)
    logger.info(f"Wrote {args.out_wav}: {len(pcm)} samples "
                f"({len(pcm) / 16000:.2f} s) from {len(feats)} frames.")


if __name__ == "__main__":
    main()
