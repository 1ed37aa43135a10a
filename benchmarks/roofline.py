"""Peaks of the card and the work of each operation, counted from its
shapes as the kernel table of PERF.md counts it.  A roofline share is the
least time (bytes at the peak bandwidth or float32 operations at the peak
rate, whichever is larger) over the measured device time."""

from __future__ import annotations

from typing import Tuple

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit.
PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12    # HBM3

ROW_BLOCK, COL_BLOCK = 16, 128   # GRU-A mask tiles the sampler reads


def least_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def frontend(T: int, S: int = 16, C: int = 64, carry: int = 40
             ) -> Tuple[float, float]:
    """(bytes, operations) of one packet call of the front-end kernel over
    T samples: the cascade of S sections (9 a sample), the squares and
    group sums, and the windows' log power; every input and output byte
    once (the samples, the sections, the states in and out, the carried
    rows in and out, the features)."""
    W = (carry + T - 50) // 10 + 1
    nbytes = 4 * (T * C + S * 6 + 2 * S * 2 * C + carry * C + W * C
                  + carry * C)
    flops = C * (9 * S * T + 2 * (carry + T) + W * (5 + 3))
    return nbytes, flops


def d1(T: int) -> Tuple[float, float]:
    """(bytes, operations) of one DSP vocoder call of T frames: features
    in, PCM out, the state in and out; ~42 operations a sample, the
    frame-rate part's products, Levinson and the noise."""
    nbytes = T * (80 + 640) + 2 * (64 + 4 + 4)
    flops = T * (160 * 42 + 2 * (18 * 18 + 18 * 161 + 161 * 17)
                 + 2 * 136 + 48 + 160 * 6)
    return nbytes, flops


def kept_tiles(mask: np.ndarray) -> float:
    """Share of GRU-A's [16 x 128] recurrent tiles the mask keeps."""
    H, G = mask.shape
    t = np.asarray(mask).reshape(H // ROW_BLOCK, ROW_BLOCK,
                                 G // COL_BLOCK, COL_BLOCK)
    return float(np.any(t != 0, axis=(1, 3)).mean())


def k2(B: int, T: int, kept: float, GA: int = 384, GB: int = 32,
       CD: int = 128, E: int = 128) -> Tuple[float, float]:
    """(bytes, operations) of one bunch-1 sampler call, B streams x T
    frames.  Operations: a sample's GRU-A (its recurrent product at the kept
    tiles), GRU-B, the two heads and the sampling; a frame's conditioning
    products.  Bytes: the weights (GRU-A's recurrent matrix at the kept
    tiles, the three fused embedding tables whole), the noise, the inputs
    and the samples, each once."""
    n = B * T * 160
    per_sample = (kept * 2 * GA * 3 * GA + 3 * 3 * GA + 2 * GA * 3 * GB
                  + 2 * GB * 3 * GB + 12 * (GA + GB)
                  + (2 * GB * 512 + 3 * 256 + 2 * 16))
    flops = n * per_sample + B * T * 2 * CD * 3 * (GA + GB)
    weights = (3 * 256 * 3 * GA + CD * 3 * GA + 3 * GA + kept * GA * 3 * GA
               + 3 * GA + (GA + CD) * 3 * GB + 3 * GB + GB * 3 * GB + 3 * GB
               + GB * 512 + 3 * 512 + 256)
    nbytes = 4 * (weights + n * 256 + B * T * (CD + 16 + 1) + n)
    return nbytes, flops


def k3(B: int, T: int, S: int, kept: float, GA: int = 384, GB: int = 32,
       CD: int = 128, E: int = 128) -> Tuple[float, float]:
    """(bytes, operations) of one bunched sampler call at bunch S, B
    streams x T frames.  Operations, a step of S samples: GRU-A's recurrent
    product at the kept tiles and the sums of its 2S + 1 gathered input
    rows, GRU-B, S head pairs, S - 1 correction pairs (two gathered rows
    added to a sub-sample's logits), the S predictions and samplings; a
    frame's conditioning products.  Bytes: the dense weights (GRU-A's
    recurrent matrix at the kept tiles and its conditioning columns, GRU-B,
    the S heads), the noise, the inputs and the samples, each once; of the
    gathered tables (the 2S + 1 fused embedding tables, [256, 3 GA] each,
    and the 2 (S - 1) corrections, [256, 256] each) one row each: which of
    their rows a call reads depends on its samples, and a table read whole
    would count more than the work needs (PERF.md's kernel table: a b8
    chunk read 1,737 of 4,352 fused rows and 1,249 of 1,792 correction
    rows).  E does not enter: the kernel reads the embedding tables fused
    with GRU-A's input rows, [256, 3 GA] each."""
    n = B * T * 160
    steps = n // S
    per_step = (kept * 2 * GA * 3 * GA + (2 * S + 1) * 3 * GA
                + 2 * GA * 3 * GB + 2 * GB * 3 * GB + 12 * (GA + GB)
                + S * (2 * GB * 512 + 3 * 256 + 2 * 16)
                + (S - 1) * 2 * 256)
    flops = steps * per_step + B * T * 2 * CD * 3 * (GA + GB)
    dense = (CD * 3 * GA + 3 * GA + kept * GA * 3 * GA + 3 * GA
             + (GA + CD) * 3 * GB + 3 * GB + GB * 3 * GB + 3 * GB
             + S * (GB * 512 + 3 * 512 + 256))
    gathered = (2 * S + 1) * 3 * GA + 2 * (S - 1) * 256
    nbytes = 4 * (dense + gathered + n * 256 + B * T * (CD + 16 + 1) + n)
    return nbytes, flops


def lstm_flops(n_in: int, H: int, layers: int, directions: int,
               T: int, head: int) -> float:
    """Multiply-adds x 2 of a stacked LSTM and its Linear head over T
    frames (the gates' products; the elementwise work left out)."""
    flops, width = 0.0, n_in
    for _ in range(layers):
        flops += directions * 2 * 4 * H * (width + H) * T
        width = directions * H
    return flops + 2 * width * head * T


def nvad(T: int) -> float:
    return lstm_flops(64, 150, 2, 1, T, 2)


def decoder(T: int) -> float:
    return lstm_flops(64, 100, 2, 2, T, 20)
