"""Sweep segment-length padding buckets for the port's online decoder
(counterpart of tools/bucket_sweep.py).

The online decode path (``dss_tpu_torch/runtime/units.py``,
``RecurrentNeuralDecodingModel``) pads each detected speech segment to a
multiple of ``length_multiple`` frames, and the units warm each bucket at
startup.  This tool scores candidate multiples against an observed
segment-length distribution (run logs' ``log.vad.lab`` rows
``start<TAB>stop<TAB>"N frames"``, or a synthetic lognormal), with the
cost model of ``runtime/bucket_policy.py`` or, with ``--measure``, the
decoder's time per bucket on the device: the port's
``BidirectionalSpeechSynthesisModel(nb_electrodes=64)`` (2 x 100, seeded),
timed by CUDA events on the card (the host clock on the CPU).  On the card
a new bucket compiles nothing, so under ``--measure`` the compile cost
defaults to 0 and padding is the whole cost.  Output: one JSON line a
candidate (the JAX tool's keys), then a recommendation::

    python tools/torch_bucket_sweep.py --lab RUN1/log.vad.lab RUN2/log.vad.lab
    python tools/torch_bucket_sweep.py --synthetic 500 --measure [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dss_tpu_torch.device import resolve_device  # noqa: E402
from dss_tpu_torch.models.decoder import \
    BidirectionalSpeechSynthesisModel  # noqa: E402
from dss_tpu_torch.runtime.bucket_policy import (  # noqa: E402
    load_lab_lengths,
    recommend_prewarm,
    score_multiple,
    synthetic_lengths,
)

REPS = 3  # timed calls a bucket, after one warm-up call


@torch.no_grad()
def bucket_ms(model: torch.nn.Module, frames: int, device) -> float:
    """Mean ms of one decoder call on a zero [1, frames, E] segment, every
    frame valid (the JAX tool's all-ones mask, as host lengths), after a
    warm-up call."""
    x = torch.zeros((1, frames, model.nb_electrodes), device=device)
    lengths = [frames]
    model(x, lengths=lengths)[0].cpu()  # warm
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            model(x, lengths=lengths)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS
    t0 = time.perf_counter()
    for _ in range(REPS):
        model(x, lengths=lengths)[0].cpu()
    return (time.perf_counter() - t0) * 1e3 / REPS


def sweep(lengths: np.ndarray, multiples, compile_cost_s: float,
          per_frame_s: float = None, measure: bool = False, device=None,
          model: torch.nn.Module = None):
    """One row a multiple: the cost model's, or with ``measure`` each
    bucket timed on ``device`` (``model`` defaults to the deployed
    64-electrode decoder)."""
    results = []
    if measure:
        device = resolve_device(device)
        if model is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                model = BidirectionalSpeechSynthesisModel(nb_electrodes=64)
        model = model.to(device).eval()
    for mult in multiples:
        if not measure:
            results.append(score_multiple(lengths, mult, compile_cost_s,
                                          per_frame_s))
            continue
        padded = -(-lengths // mult) * mult
        buckets = Counter(padded.tolist())
        total = 0.0
        for bucket_len, count in sorted(buckets.items()):
            total += bucket_ms(model, int(bucket_len), device) / 1e3 * count
        results.append({
            "length_multiple": int(mult),
            "buckets": len(buckets),
            "padding_overhead": round(
                float(np.mean(padded / lengths) - 1.0), 4),
            "mean_inference_ms": round(total / len(lengths) * 1e3, 3),
            "est_session_s": round(total + len(buckets) * compile_cost_s, 3),
        })
    return results


def main(argv=None, model: torch.nn.Module = None) -> list:
    """Prints the JSON lines and returns them as dicts."""
    parser = argparse.ArgumentParser(
        "Sweep decoder segment-padding bucket sizes against a segment-length "
        "distribution.")
    parser.add_argument("--lab", nargs="+", default=None,
                        help="log.vad.lab files with observed segments.")
    parser.add_argument("--synthetic", type=int, default=None, metavar="N",
                        help="Use N synthetic lognormal segment lengths "
                             "instead of .lab files.")
    parser.add_argument("--multiples", type=int, nargs="+",
                        default=[10, 25, 50, 75, 100, 150])
    parser.add_argument("--compile-cost", type=float, default=None,
                        help="Seconds charged per new bucket (default 30, "
                             "the JAX tool's compile; 0 with --measure: "
                             "the card compiles nothing).")
    parser.add_argument("--per-frame-us", type=float, default=150.0,
                        help="Modeled inference cost per padded frame "
                             "(microseconds) when not measuring.")
    parser.add_argument("--measure", action="store_true",
                        help="Time the decoder per bucket on --device "
                             "instead of the cost model.")
    parser.add_argument("--prewarm-coverage", type=float, default=0.98,
                        help="Fraction of observed segments the recommended "
                             "prewarm bucket list must cover.")
    parser.add_argument("--device", default=None,
                        help="Torch device for --measure (default: cuda).")
    args = parser.parse_args(argv)
    compile_cost = args.compile_cost if args.compile_cost is not None \
        else (0.0 if args.measure else 30.0)

    if args.lab:
        lengths = load_lab_lengths(args.lab)
        if len(lengths) == 0:
            raise SystemExit("no segments found in the given .lab files")
    elif args.synthetic:
        lengths = synthetic_lengths(args.synthetic)
    else:
        raise SystemExit("pass --lab FILES or --synthetic N")

    lines = [{
        "segments": len(lengths),
        "frames_p50": int(np.percentile(lengths, 50)),
        "frames_p90": int(np.percentile(lengths, 90)),
        "frames_max": int(lengths.max()),
    }]
    print(json.dumps(lines[0]), flush=True)
    results = sweep(lengths, args.multiples, compile_cost,
                    per_frame_s=args.per_frame_us * 1e-6,
                    measure=args.measure, device=args.device, model=model)
    lines += results
    best = min(results, key=lambda r: r["est_session_s"])
    prewarm = recommend_prewarm(lengths, best["length_multiple"],
                                coverage=args.prewarm_coverage)
    lines.append({
        "recommended_length_multiple": best["length_multiple"],
        "recommended_prewarm_frames": prewarm,
        # Paste-ready for config/debug_settings.ini [Decoding]:
        "ini": (f"segment_length_multiple = {best['length_multiple']}\n"
                f"segment_prewarm_frames = {prewarm}"),
    })
    for line in lines[1:]:
        print(json.dumps(line))
    return lines


if __name__ == "__main__":
    main()
