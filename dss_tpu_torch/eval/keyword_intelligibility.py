"""Keyword-vocabulary intelligibility of a vocoder checkpoint (counterpart
of eval/keyword_intelligibility.py).

Round-trips every ``kw_<word>_<n>.wav`` in a directory through encode ->
synthesize (or, with ``--syn-dir``, takes pre-rendered wavs of the same
names) and reports keyword-ID accuracy (DTW Bark-cepstral nearest
original; chance = 1/#words), mean STOI, mean cepstral distortion and
per-word diagnostics, optionally over a noise sweep, as one JSON object on
stdout::

    python -m dss_tpu_torch.eval.keyword_intelligibility VAL_DIR \
        --backend net --weights weights/vocoder_speech.npz [--device cpu]

``--device`` takes the place of the JAX script's ``--platform`` and
``--pallas``.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np
from scipy.io import wavfile

from ..vocoder.features import LPCFeatureEncoder
from ..vocoder.lpcnet import LPCNet
from .quality import keyword_id_report, score, stoi

_KW_RE = re.compile(r"^kw_([a-z]+)_(\d+)\.wav$")


def collect_keywords(directory: str):
    """-> {word: [wav array, ...]} from kw_<word>_<n>.wav files."""
    words = {}
    for name in sorted(os.listdir(directory)):
        m = _KW_RE.match(name)
        if not m:
            continue
        fs, audio = wavfile.read(os.path.join(directory, name))
        if fs != 16000:
            raise SystemExit(f"{name}: expected 16 kHz, got {fs}")
        if audio.ndim > 1:
            audio = audio[:, 0]
        words.setdefault(m.group(1), []).append(audio)
    if not words:
        raise SystemExit(f"no kw_<word>_<n>.wav files in {directory}")
    return words


def _resynthesize(vocoder, audio, device):
    """(the round trip's samples, its length feats x 160)."""
    feats = LPCFeatureEncoder(device=device).compute_LPC_features(audio)
    vocoder.reset_decoder()
    return vocoder.synthesize_frames(feats), len(feats) * 160


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        "Round-trip keyword wavs through a vocoder and score "
        "identification accuracy + STOI.")
    ap.add_argument("directory", help="Directory of kw_<word>_<n>.wav files "
                                      "(16 kHz mono).")
    ap.add_argument("--backend", default="net", choices=("dsp", "net"))
    ap.add_argument("--weights", default=None,
                    help="Neural vocoder weights (.npz) for --backend net.")
    ap.add_argument("--temperature-scale", type=float, default=1.0,
                    help="Sampling sharpening multiplier (net backend).")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="Torch device (default: cuda).")
    ap.add_argument("--syn-dir", default=None,
                    help="Score pre-rendered kw_<word>_<n>.wav files from "
                         "this directory against the originals instead of "
                         "round-tripping through a vocoder (e.g. a closed-"
                         "loop run's reco wavs laid out by word).")
    ap.add_argument("--snr-sweep", default=None,
                    help="Comma-separated SNRs in dB (e.g. '20,10,5,0'): "
                         "additionally score noise-corrupted inputs at "
                         "each SNR against the clean originals.  Vocoder "
                         "mode only.")
    args = ap.parse_args(argv)
    device = args.device

    words = collect_keywords(args.directory)
    if args.syn_dir:
        vocoder = None
        pre_rendered = collect_keywords(args.syn_dir)
        missing = set(words) - set(pre_rendered)
        if missing:
            raise SystemExit(f"--syn-dir lacks words: {sorted(missing)}")
    else:
        pre_rendered = None
        vocoder = LPCNet(backend=args.backend, weights=args.weights,
                         seed=args.seed,
                         temperature_scale=args.temperature_scale,
                         device=device)

    originals, resyntheses = {}, {}
    per_word = {}
    dists, stois = [], []
    for word, variants in sorted(words.items()):
        originals[word] = []
        resyntheses[word] = []
        wd, ws = [], []
        syn_variants = (pre_rendered[word] if pre_rendered is not None
                        else variants)
        if len(syn_variants) != len(variants):
            # zip() would drop the unmatched originals and skew the scores.
            raise SystemExit(
                f"--syn-dir has {len(syn_variants)} rendering(s) for "
                f"'{word}' but {len(variants)} original(s)")
        for audio, rendered in zip(variants, syn_variants):
            if vocoder is not None:
                syn, n = _resynthesize(vocoder, audio, device)
            else:
                syn = rendered
                n = min(len(audio), len(syn))
            orig = audio[:n]
            originals[word].append(orig)
            resyntheses[word].append(syn[:n])
            r = score(orig, syn[:n], device=device)
            wd.append(r.cepstral_distance_db)
            try:
                ws.append(stoi(orig, syn[:n]))
            except ValueError:
                pass  # too short / all-silent for the STOI window
        per_word[word] = {
            "n": len(variants),
            "cepstral_distance_db": round(float(np.mean(wd)), 3),
            **({"stoi": round(float(np.mean(ws)), 4)} if ws else {}),
        }
        dists.extend(wd)
        stois.extend(ws)

    report = keyword_id_report(originals, resyntheses, device)
    margin_vals = [m["margin"] for m in report["margins"]
                   if np.isfinite(m.get("margin", np.nan))]
    out = {
        "keyword_id_accuracy": round(report["accuracy"], 4),
        "confusion": report["confusion"],
        "margins": report["margins"],
        **({"margin_min": round(float(np.min(margin_vals)), 4),
            "margin_median": round(float(np.median(margin_vals)), 4)}
           if margin_vals else {}),
        "chance": round(1.0 / len(words), 4),
        "num_words": len(words),
        "num_utterances": int(sum(len(v) for v in words.values())),
        "cepstral_distance_db_mean": round(float(np.mean(dists)), 3),
        **({"stoi_mean": round(float(np.mean(stois)), 4)} if stois else {}),
        "backend": args.backend if not args.syn_dir else "pre-rendered",
        "syn_dir": args.syn_dir,
        "weights": args.weights,
        "temperature_scale": args.temperature_scale,
        "per_word": per_word,
    }

    if args.snr_sweep and vocoder is not None:
        rng = np.random.default_rng(args.seed + 1)
        sweep = {}
        for snr_db in (float(s) for s in args.snr_sweep.split(",")):
            noisy_res = {}
            sweep_d, sweep_s = [], []
            for word, variants in sorted(words.items()):
                noisy_res[word] = []
                for audio in variants:
                    x = np.asarray(audio, np.float64)
                    sig_p = float(np.mean(x ** 2)) + 1e-12
                    noise = rng.standard_normal(len(x))
                    noise *= np.sqrt(sig_p / 10.0 ** (snr_db / 10.0))
                    noisy = np.clip(x + noise, -32768, 32767)
                    syn, n = _resynthesize(vocoder, noisy.astype(np.int16),
                                           device)
                    noisy_res[word].append(syn[:n])
                    clean = np.asarray(audio[:n])
                    r = score(clean, syn[:n], device=device)
                    sweep_d.append(r.cepstral_distance_db)
                    try:
                        sweep_s.append(stoi(clean, syn[:n]))
                    except ValueError:
                        pass
            rep = keyword_id_report(originals, noisy_res, device)
            sweep[f"{snr_db:g}dB"] = {
                "keyword_id_accuracy": round(rep["accuracy"], 4),
                "cepstral_distance_db_mean":
                    round(float(np.mean(sweep_d)), 3),
                **({"stoi_mean": round(float(np.mean(sweep_s)), 4)}
                   if sweep_s else {}),
            }
        out["noise_robustness"] = sweep

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
