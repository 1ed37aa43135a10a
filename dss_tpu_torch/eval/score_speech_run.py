"""Score a --speech replicate run's reco wavs as keyword speech
(counterpart of tools/score_speech_run.py).

tools/make_replicate_dataset.py --speech embeds formant-synthesized
keywords in the fabricated sessions, so a closed-loop run over its online
session renders keywords.  This maps each logged segment back to its word
by replay time (``word_order.json``; modulo the session length for looped
replays), and scores keyword identification and STOI against the
session's own keyword templates (``keyword_templates/`` in the dataset
base) and, with ``--shifted-dir``, against speaker-shifted templates the
models never saw (tools/make_speech_corpus.py --shifted-val).

    python -m dss_tpu_torch.eval.score_speech_run RUN_DIR DATASET_BASE \
        [--shifted-dir DIR] [--device cpu] [--out report.json]

``--device`` (the feature encoder's) takes the place of ``--platform``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from scipy.io import wavfile

from .keyword_intelligibility import collect_keywords
from .quality import keyword_id_report, stoi


def map_segments_to_words(run_dir: str, order: dict,
                          max_dist_s: float = 2.0):
    """([(reco_index, word)], skipped) for the logged segments: each goes
    to the word whose span centre is cyclically nearest the segment's
    replay-time midpoint (modulo the session length).  Nearest centre
    rather than containment: a looped replay drifts a little a loop and
    the VAD's smoothing offsets segment times by ~0.5 s, while word spans
    are >= 5 s apart.  Segments farther than ``max_dist_s`` from every
    centre are skipped and counted."""
    session_s = float(order["session_seconds"])
    centers = [(w["word"], (w["t0"] + w["t1"]) / 2.0)
               for w in order["words"]]
    out, skipped = [], 0
    with open(os.path.join(run_dir, "log.vad.lab")) as fd:
        for i, line in enumerate(fd):
            parts = line.strip().split("\t")
            if len(parts) != 3:
                continue
            s, e = float(parts[0]), float(parts[1])
            mid = ((s + e) / 2.0) % session_s

            def cyc(a, b):
                d = abs(a - b) % session_s
                return min(d, session_s - d)

            word, dist = min(((w, cyc(mid, c)) for w, c in centers),
                             key=lambda t: t[1])
            if dist <= max_dist_s:
                out.append((i + 1, word))
            else:
                skipped += 1
    return out, skipped


def energy_trim(audio: np.ndarray, pad_s: float = 0.05,
                rel: float = 0.08) -> np.ndarray:
    """Trim leading and trailing low-energy material (a threshold relative
    to the peak of a 50 ms envelope).  VAD segments carry ~0.5 s of
    trailing silence; DTW against bare word templates would map it onto
    the templates' edges and swamp the word distance."""
    x = np.abs(audio.astype(np.float64))
    env = np.convolve(x, np.ones(800) / 800.0, mode="same")
    thr = env.max() * rel
    idx = np.nonzero(env > thr)[0]
    if len(idx) == 0:
        return audio
    pad = int(pad_s * 16000)
    lo = max(0, int(idx[0]) - pad)
    hi = min(len(audio), int(idx[-1]) + pad)
    return audio[lo:hi]


def _floor_dither(audio: np.ndarray, rng, rms: float = 40.0) -> np.ndarray:
    """Add a common ~-58 dBFS noise floor before scoring: the cepstral DTW
    compares absolute band energies, so closure frames would otherwise
    score the two signals' noise floors (artifacts of provenance) against
    each other.  Word content (>= 3000 RMS) is untouched."""
    return (audio.astype(np.float64)
            + rng.normal(0.0, rms, len(audio))).astype(np.float64)


def score_against(templates_dir: str, rendered: dict, device=None) -> dict:
    """Keyword ID, confusion, margins and STOI of ``rendered`` ({word:
    [int16 wav]}) against the kw_<word>_<n>.wav templates of
    ``templates_dir``."""
    rng = np.random.default_rng(0)
    originals = collect_keywords(templates_dir)
    originals = {w: [_floor_dither(v, rng) for v in vs]
                 for w, vs in originals.items()}
    rendered = {w: [_floor_dither(v, rng) for v in vs]
                for w, vs in rendered.items()}
    missing = set(rendered) - set(originals)
    if missing:
        raise SystemExit(f"templates lack words: {sorted(missing)}")
    report = keyword_id_report(
        {w: originals[w] for w in rendered}, rendered, device)
    stois = []
    for word, syns in rendered.items():
        for syn in syns:
            ref = originals[word][0]
            n = min(len(ref), len(syn))
            try:
                stois.append(stoi(ref[:n], syn[:n]))
            except ValueError:
                pass
    margins = [m["margin"] for m in report["margins"]
               if np.isfinite(m.get("margin", np.nan))]
    return {
        "keyword_id_accuracy": round(report["accuracy"], 4),
        "n": int(sum(len(v) for v in rendered.values())),
        "confusion": report["confusion"],
        "margins": report["margins"],
        **({"margin_min": round(float(np.min(margins)), 4),
            "margin_median": round(float(np.median(margins)), 4)}
           if margins else {}),
        **({"stoi_mean": round(float(np.mean(stois)), 4)} if stois else {}),
    }


def score_run(run_dir: str, dataset_base: str, shifted_dir: str = None,
              device=None) -> dict:
    """The report of ``main`` for one run directory."""
    with open(os.path.join(dataset_base, "word_order.json")) as fd:
        order = json.load(fd)
    mapping, skipped = map_segments_to_words(run_dir, order)
    if not mapping:
        raise SystemExit("no segments mapped to words")

    rendered: dict = {}
    for reco_idx, word in mapping:
        path = os.path.join(run_dir, "reco", f"reco_{reco_idx:05d}.wav")
        fs, audio = wavfile.read(path)
        if fs != 16000:
            raise SystemExit(f"{path}: expected 16 kHz, got {fs}")
        rendered.setdefault(word, []).append(energy_trim(audio))

    out = {
        "run_dir": run_dir,
        "n_segments_scored": len(mapping),
        "n_segments_unmapped": skipped,
        "words_covered": sorted(rendered),
        "vs_own_templates": score_against(
            os.path.join(dataset_base, "keyword_templates"), rendered,
            device),
    }
    if shifted_dir:
        out["vs_shifted_templates"] = score_against(shifted_dir, rendered,
                                                    device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        "Score a --speech replicate run's reco wavs as keywords.")
    ap.add_argument("run_dir")
    ap.add_argument("dataset_base",
                    help="make_replicate_dataset --speech output base "
                         "(word_order.json + keyword_templates/).")
    ap.add_argument("--shifted-dir", default=None,
                    help="Additionally score against speaker-shifted "
                         "templates (make_speech_corpus --shifted-val).")
    ap.add_argument("--device", default=None,
                    help="Torch device of the feature encoder (default: "
                         "cuda).")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = score_run(args.run_dir, args.dataset_base, args.shifted_dir,
                    args.device)
    js = json.dumps(out)
    print(js)
    if args.out:
        with open(args.out, "w") as fd:
            fd.write(js + "\n")
    return out


if __name__ == "__main__":
    main()
