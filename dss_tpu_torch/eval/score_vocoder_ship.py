"""Ship-gate scorer for vocoder checkpoints, the reship protocol
(counterpart of tools/score_vocoder_ship.py).

Free-running vocoder quality varies +-1.5 dB per utterance and seed, so
one validation number is no evidence for shipping.  The protocol scores
each candidate on two fresh unseen-seed corpus draws (12 keyword variants
and 4 sentence utterances each, tools/make_speech_corpus.py --seconds 4)
and asks it to win on both means and keep the keywords identifiable.  For
each candidate and seed: mean and max Bark-cepstral round-trip distortion
over the val utterances, keyword-ID accuracy and mean STOI over the
keyword round trips; one JSON report on stdout::

    python -m dss_tpu_torch.eval.score_vocoder_ship CANDIDATE.npz [...] \
        [--seeds 777 888] [--device cpu]

``--device`` takes the place of the JAX script's ``--platform`` and
``--pallas``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
from scipy.io import wavfile

from ..vocoder.features import LPCFeatureEncoder
from ..vocoder.lpcnet import LPCNet
from .quality import keyword_id_accuracy, score_roundtrip, stoi

REPO = Path(__file__).resolve().parents[2]


def make_corpus(out_dir: Path, seed: int) -> Path:
    """tools/make_speech_corpus.py --seconds 4 into ``out_dir``; -> its
    val/ directory."""
    subprocess.run(
        [sys.executable, str(REPO / "tools" / "make_speech_corpus.py"),
         str(out_dir), "--seconds", "4", "--seed", str(seed)],
        check=True, capture_output=True)
    return out_dir / "val"


def score_candidate(weights: str, val_dir: Path, device=None) -> dict:
    """One candidate on one corpus draw's val/ directory."""
    vocoder = LPCNet(backend="net", weights=weights, device=device)
    enc = LPCFeatureEncoder(device=device)

    distortions = {}
    originals, resyntheses, stois = {}, {}, []
    for wav in sorted(Path(val_dir).glob("*.wav")):
        _, audio = wavfile.read(wav)
        vocoder.reset_decoder()
        report = score_roundtrip(audio, vocoder, device=device)
        distortions[wav.name] = round(report.cepstral_distance_db, 2)
        if wav.name.startswith("kw_"):
            word = wav.name.split("_")[1]
            feats = enc.compute_LPC_features(audio)
            vocoder.reset_decoder()
            syn = vocoder.synthesize_frames(feats)
            n = len(feats) * 160
            originals.setdefault(word, []).append(audio[:n])
            resyntheses.setdefault(word, []).append(syn[:n])
            try:
                stois.append(stoi(audio[:n], syn[:n]))
            except ValueError:
                pass  # keyword too short for the STOI frame minimum

    vals = list(distortions.values())
    return {
        "mean_db": round(float(np.mean(vals)), 2),
        "max_db": round(float(np.max(vals)), 2),
        "keyword_id": round(keyword_id_accuracy(originals, resyntheses,
                                                device), 3),
        "stoi": round(float(np.mean(stois)), 3),
        "per_wav_db": distortions,
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Score vocoder ship candidates on fresh unseen-seed "
                    "corpus draws (the reship protocol).")
    parser.add_argument("weights", nargs="+",
                        help="Candidate checkpoint(s) (.npz).")
    parser.add_argument("--seeds", type=int, nargs="+", default=[777, 888],
                        help="Fresh corpus seeds (unseen by training and by "
                             "earlier gate fixtures when comparing against "
                             "shipped scores).")
    parser.add_argument("--device", default=None,
                        help="Torch device (default: cuda).")
    args = parser.parse_args(argv)

    report = {"seeds": args.seeds, "candidates": {}}
    with tempfile.TemporaryDirectory() as tmp:
        val_dirs = {seed: make_corpus(Path(tmp) / f"seed{seed}", seed)
                    for seed in args.seeds}
        for weights in args.weights:
            per_seed = {}
            for seed, val_dir in val_dirs.items():
                per_seed[str(seed)] = score_candidate(weights, val_dir,
                                                      args.device)
                print(f"[{weights}] seed {seed}: "
                      f"mean {per_seed[str(seed)]['mean_db']} dB, "
                      f"keyword-ID {per_seed[str(seed)]['keyword_id']}, "
                      f"STOI {per_seed[str(seed)]['stoi']}",
                      file=sys.stderr)
            report["candidates"][weights] = per_seed
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
