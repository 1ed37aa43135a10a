"""Objective vocoder quality scoring: cepstral distortion and band-level
SNR (counterpart of eval/vocoder_quality.py).

Two modes:

* ``--roundtrip REF.wav``: encode the wav with the port's feature encoder,
  synthesize with the chosen backend and score the synthesis against the
  input: the standing regression check of a vocoder backend or checkpoint;
* ``REF.wav SYN.wav``: score two existing waveforms.

    python -m dss_tpu_torch.eval.vocoder_quality REF.wav --roundtrip \
        --backend net --weights W.npz [--device cpu]

``--device`` takes the place of the JAX script's ``--platform`` and
``--pallas``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
from scipy.io import wavfile

from ..vocoder.lpcnet import LPCNet
from .quality import score, score_roundtrip


def _load(path: str) -> np.ndarray:
    fs, audio = wavfile.read(path)
    if fs != 16000:
        raise SystemExit(f"{path}: expected 16 kHz, got {fs} Hz")
    if audio.ndim > 1:
        audio = audio[:, 0]
    return audio


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        "Score vocoder output quality (Bark-cepstral distortion, dB).")
    parser.add_argument("reference", help="Reference wav (16 kHz mono).")
    parser.add_argument("synthesized", nargs="?", default=None,
                        help="Synthesized wav to score against the "
                             "reference; omit with --roundtrip.")
    parser.add_argument("--roundtrip", action="store_true",
                        help="Encode + synthesize the reference and score "
                             "the round trip instead of comparing two wavs.")
    parser.add_argument("--backend", default="dsp", choices=("dsp", "net"),
                        help="Vocoder backend for --roundtrip.")
    parser.add_argument("--weights", default=None,
                        help="Neural vocoder weights (.npz) for "
                             "--backend net.")
    parser.add_argument("--device", default=None,
                        help="Torch device (default: cuda).")
    args = parser.parse_args(argv)

    ref = _load(args.reference)
    if args.roundtrip:
        vocoder = LPCNet(backend=args.backend, weights=args.weights,
                         device=args.device)
        report = score_roundtrip(ref, vocoder, device=args.device)
    else:
        if args.synthesized is None:
            raise SystemExit("need SYN.wav (or pass --roundtrip)")
        report = score(ref, _load(args.synthesized), device=args.device)

    out = {
        "cepstral_distance_db": round(report.cepstral_distance_db, 3),
        "band_level_snr_db": round(report.band_level_snr_db, 3),
        "num_frames": report.num_frames,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
