"""Segment-padding bucket policy from observed segment-length logs (the
port's own copy of dss_tpu/runtime/bucket_policy.py; numpy only).

The online decoder pads every completed speech segment to a multiple of
``length_multiple`` frames, and the units warm each bucket at startup.
The policy trades the number of buckets against padded-frame waste, scored
on the deployment's own segment-length distribution (``log.vad.lab`` rows
``start<TAB>stop<TAB>"N frames"``).  ``decode_online`` with
``segment_policy_labs`` set picks ``segment_length_multiple`` and
``segment_prewarm_frames`` from prior runs' labs at startup.  The cost
model keeps the JAX package's constants (a bucket's first use cost a
compile there), so both packages pick the same buckets from the same labs.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_MULTIPLES = (10, 25, 50, 75, 100, 150)


def load_lab_lengths(paths: Sequence[str]) -> np.ndarray:
    """Segment lengths in frames from .lab files (third column 'N frames')."""
    lengths = []
    for p in paths:
        with open(p) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) == 3 and parts[2].endswith("frames"):
                    lengths.append(int(parts[2].split()[0]))
    return np.asarray(lengths, np.int64)


def synthetic_lengths(n: int, mean_s: float = 1.6, sigma: float = 0.5,
                      seed: int = 0) -> np.ndarray:
    """Lognormal segment durations (seconds -> 100 fps frames), matching the
    shape of single-word utterance distributions."""
    rng = np.random.default_rng(seed)
    dur = rng.lognormal(mean=math.log(mean_s), sigma=sigma, size=n)
    return np.maximum((dur * 100).astype(np.int64), 10)


def score_multiple(lengths: np.ndarray, mult: int, compile_cost_s: float,
                   per_frame_s: float) -> dict:
    """Expected-session-cost model for one candidate multiple."""
    padded = -(-lengths // mult) * mult
    buckets = Counter(padded.tolist())
    total = float(np.sum(padded)) * per_frame_s
    return {
        "length_multiple": int(mult),
        "buckets": len(buckets),
        "padding_overhead": round(float(np.mean(padded / lengths) - 1.0), 4),
        "mean_inference_ms": round(total / len(lengths) * 1e3, 3),
        "est_session_s": round(total + len(buckets) * compile_cost_s, 3),
    }


def recommend_prewarm(lengths: np.ndarray, mult: int,
                      coverage: float = 0.98) -> List[int]:
    """Bucket lengths (multiples of ``mult``) to pre-compile at startup:
    the most frequent observed buckets, greedily added until ``coverage``
    of segments hit a prewarmed program."""
    padded = -(-lengths // mult) * mult
    counts = Counter(padded.tolist())
    picked, covered = [], 0
    for bucket, n in counts.most_common():
        picked.append(int(bucket))
        covered += n
        if covered >= coverage * len(lengths):
            break
    return sorted(picked)


def choose_policy(lengths: np.ndarray,
                  multiples: Sequence[int] = DEFAULT_MULTIPLES,
                  compile_cost_s: float = 30.0,
                  per_frame_s: float = 150e-6,
                  coverage: float = 0.98) -> Tuple[int, Tuple[int, ...]]:
    """(length_multiple, prewarm_frames) minimizing expected session cost."""
    rows = [score_multiple(lengths, m, compile_cost_s, per_frame_s)
            for m in multiples]
    best = min(rows, key=lambda r: r["est_session_s"])
    mult = best["length_multiple"]
    return mult, tuple(recommend_prewarm(lengths, mult, coverage))
