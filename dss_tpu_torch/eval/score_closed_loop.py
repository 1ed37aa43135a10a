"""Score a closed-loop run's reco wavs against offline resynthesis
(counterpart of tools/score_closed_loop.py).

The closed loop logs, per completed speech segment, the decoded LPC
features (``log.lpc.f32``, [T, 20] float32 rows) and the audio the online
vocoder synthesized from them (``reco/reco_%05d.wav``).  This resynthesizes
each segment offline from the same logged features with the same
checkpoint (the port's ``LPCNet``: the sampler kernel at the checkpoint's
bunch) and scores both renderings against the logged conditioning: the
Bark-cepstral distance between each waveform's encoded band energies and
the bands the features prescribe.  ``delta_db`` = online - offline per
segment; the expectation is |mean delta| < 1 dB.

    python -m dss_tpu_torch.eval.score_closed_loop RUN_DIR --weights W.npz \
        [--device cpu] [--quiet-sharpen] [--out report.json]

``--device`` takes the place of the JAX script's ``--platform`` and
``--pallas`` (one sampler per device).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np
from scipy.io import wavfile

from ..vocoder.lpc import DCT_MATRIX, NB_BANDS
from ..vocoder.lpcnet import LPCNet
from .quality import _FLOOR_DB, _log_bands


def read_segments(run_dir: str):
    """-> (list of [T, 20] feature arrays, list of reco waveforms)."""
    lpc = np.fromfile(os.path.join(run_dir, "log.lpc.f32"),
                      dtype=np.float32).reshape(-1, 20)
    lengths = []
    with open(os.path.join(run_dir, "log.vad.lab")) as fd:
        for line in fd:
            parts = line.strip().split("\t")
            if len(parts) == 3:
                lengths.append(int(parts[2].split()[0]))
    if sum(lengths) != len(lpc):
        raise SystemExit(
            f"log.vad.lab frames ({sum(lengths)}) != log.lpc.f32 rows "
            f"({len(lpc)}) — partial/unflushed run?")
    feats, recos, off = [], [], 0
    for i, n in enumerate(lengths):
        feats.append(lpc[off:off + n])
        off += n
        path = os.path.join(run_dir, "reco", f"reco_{i + 1:05d}.wav")
        fs, audio = wavfile.read(path)
        if fs != 16000:
            raise SystemExit(f"{path}: expected 16 kHz, got {fs}")
        if len(audio) != n * 160:
            raise SystemExit(f"{path}: {len(audio)} samples != {n}*160")
        recos.append(audio)
    return feats, recos


def fidelity_db(feats: np.ndarray, audio: np.ndarray,
                skip_frames: int = 2, device=None) -> float:
    """Bark-cepstral distance (dB) between a waveform's encoded band
    energies and the band energies its conditioning features prescribe
    (``quality.cepstral_distance`` with the reference bands taken from the
    features)."""
    ref = feats[:, :NB_BANDS].astype(np.float64) @ DCT_MATRIX
    peak = np.max(ref, axis=1, keepdims=True)
    ref = np.maximum(ref, peak - _FLOOR_DB / 10.0)
    got = _log_bands(audio, device)
    n = min(len(ref), len(got))
    if n <= skip_frames:
        raise ValueError(f"segment too short: {n} frames")
    d_db = 10.0 * (ref[skip_frames:n] - got[skip_frames:n])
    return float(np.mean(np.sqrt(np.mean(d_db * d_db, axis=1))))


def score_run(run_dir: str, weights, seed: int = 0, min_frames: int = 30,
              limit: int = 0, quiet_sharpen: bool = False,
              device=None) -> dict:
    """The report of ``main`` for one run directory."""
    # The comparison means something only when the offline resynthesis
    # uses the vocoder the run used; decode_online logs its config (either
    # package's log line).
    run_log = os.path.join(run_dir, "log.run.txt")
    if os.path.exists(run_log):
        with open(run_log) as fd:
            for line in fd:
                m = re.search(r"[Vv]ocoder: (backend=\S+ weights=[^;\s]*)",
                              line)
                if m:
                    cfg = m.group(1)
                    if "backend=net" not in cfg or \
                            os.path.basename(str(weights)) not in cfg:
                        print(f"WARNING: run used '{cfg}' but scoring "
                              f"against {weights} — deltas compare "
                              f"different vocoders, not the online path",
                              file=sys.stderr)
                    break

    feats, recos = read_segments(run_dir)
    voc = LPCNet(backend="net", weights=weights, seed=seed,
                 quiet_sharpen=quiet_sharpen, device=device)

    eligible = [i for i, f in enumerate(feats) if len(f) >= min_frames]
    if limit and len(eligible) > limit:
        sel = np.linspace(0, len(eligible) - 1, limit).astype(int)
        eligible = [eligible[k] for k in sel]

    rows = []
    for i in eligible:
        f, reco = feats[i], recos[i]
        voc.reset_decoder()
        offline = voc.synthesize_frames(f)[: len(f) * 160]
        d_on = fidelity_db(f, reco, device=device)
        d_off = fidelity_db(f, offline, device=device)
        rows.append({"segment": i + 1, "frames": len(f),
                     "online_db": round(d_on, 3),
                     "offline_db": round(d_off, 3),
                     "delta_db": round(d_on - d_off, 3)})

    if not rows:
        raise SystemExit(f"no segments >= {min_frames} frames")
    deltas = [r["delta_db"] for r in rows]
    return {
        "run_dir": run_dir,
        "weights": str(weights),
        "n_segments": len(rows),
        "online_db_mean": round(float(np.mean([r["online_db"]
                                               for r in rows])), 3),
        "offline_db_mean": round(float(np.mean([r["offline_db"]
                                                for r in rows])), 3),
        "delta_db_mean": round(float(np.mean(deltas)), 3),
        "delta_db_max": round(float(np.max(np.abs(deltas))), 3),
        "segments": rows,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        "Score closed-loop reco wavs vs offline resynthesis of the same "
        "logged features.")
    ap.add_argument("run_dir", help="decode_online run directory "
                                    "(log.lpc.f32 + log.vad.lab + reco/)")
    ap.add_argument("--weights", required=True,
                    help="The vocoder checkpoint the run used (.npz).")
    ap.add_argument("--device", default=None,
                    help="Torch device (default: cuda).")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-frames", type=int, default=30,
                    help="Skip segments shorter than this (transient-"
                         "dominated scores).")
    ap.add_argument("--limit", type=int, default=0,
                    help="Score at most this many segments (0 = all); "
                         "evenly spaced over the run.")
    ap.add_argument("--out", default=None, help="Also write JSON here.")
    ap.add_argument("--quiet-sharpen", action="store_true",
                    help="Match the online units' quiet-frame squelch "
                         "(decode_online turns it on) so the offline "
                         "rendering runs the same sampler config.")
    args = ap.parse_args(argv)
    report = score_run(args.run_dir, args.weights, seed=args.seed,
                       min_frames=args.min_frames, limit=args.limit,
                       quiet_sharpen=args.quiet_sharpen, device=args.device)
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as fd:
            json.dump(report, fd, indent=1)
    return report


if __name__ == "__main__":
    main()
