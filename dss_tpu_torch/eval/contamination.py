"""Acoustic-contamination analysis (counterpart of
dss_tpu/eval/contamination.py and of its CLI,
eval/contamination/contamination_analysis.py): the permutation test of
Roussel et al. 2020 on a day's aggregated recording, with its 10,000
surrogates batched on the card.

    python -m dss_tpu_torch.eval.contamination --agg-path DIR --out DIR
        [--device cuda|cpu]

Per day (parameters as in the reference's MATLAB call):
1. artifact detection: detrend with a 0.5 s moving average; a sample is an
   artifact when >= 1/10 of the channels exceed 5x their MAD; +-0.5 s
   safety margin around detections;
2. spectrograms of the audio and of every ECoG channel: 200 ms windows at
   a 50 Hz frame rate, the 70-170 Hz band;
3. correlations of the audio's and each channel's spectrogram, per
   frequency bin, on the artifact-free frames, over +-0.5 s of lags;
4. the dataset measure: the mean over (channel, frequency) of the largest
   absolute lagged correlation; surrogates repeat it with the audio
   spectrogram circularly shifted by random offsets beyond the lag window;
   the criterion P is the fraction of surrogates >= the dataset measure.

Steps 1-3 and the dataset measure run in numpy and scipy on the host
(``lagged_correlation_measure`` is also the plain version of the
surrogates).  ``surrogate_measures`` runs the surrogates as torch on the
device: per chunk of shifts one gather of the shifted audio spectrogram,
then one batched product per lag.  An error there raises; nothing falls
back to the host loop.  ``analyze_day`` writes
``{day}_contamination_result.mat`` with ``out.surrogate_measures``,
``out.dataset_measure`` and ``out.criterion_value``, which
eval/contamination/gen_contamination_report.py reads.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
from scipy.io import loadmat, savemat

from ..device import resolve_device

logger = logging.getLogger("dss_tpu_torch.eval.contamination")

MOVING_AVERAGE_SPAN = 0.5
ARTIFACT_THRESHOLD_FACTOR = 5.0
ARTIFACT_CHANNEL_RATIO = 1.0 / 10.0
ARTIFACT_SAFETY_PERIOD = 0.5
WINDOW_DURATION = 200e-3
SPG_FS = 50
FREQ_BOUNDS = (70.0, 170.0)
MAX_TIME_LAG = 0.5
NB_SURROGATES = 10_000
# Shifts per batched product: the gathered audio spectrogram of a chunk is
# [freqs, chunk, frames + 2 * lags] float32 (~2.6 GB at 1024 shifts of a
# 10-minute day), and 1024 rows keep the card's product wide.
SURROGATE_CHUNK = 1024


def moving_average_detrend(x: np.ndarray, fs: float,
                           span: float = MOVING_AVERAGE_SPAN) -> np.ndarray:
    win = max(int(span * fs), 1)
    kernel = np.ones(win) / win
    trend = np.apply_along_axis(
        lambda c: np.convolve(c, kernel, mode="same"), 0, x)
    return x - trend


def detect_artifacts(ecog: np.ndarray, fs: float) -> np.ndarray:
    """Boolean per-sample artifact mask (True = artifact)."""
    detrended = moving_average_detrend(ecog, fs)
    mad = np.median(np.abs(detrended - np.median(detrended, axis=0)), axis=0)
    over = np.abs(detrended) > ARTIFACT_THRESHOLD_FACTOR * np.maximum(mad,
                                                                      1e-12)
    artifact = over.mean(axis=1) >= ARTIFACT_CHANNEL_RATIO

    # Safety margin: dilate by +-safety seconds.
    margin = int(ARTIFACT_SAFETY_PERIOD * fs)
    if margin > 0 and artifact.any():
        mask = np.zeros(len(artifact), dtype=bool)
        for i in np.flatnonzero(artifact):
            mask[max(0, i - margin):i + margin + 1] = True
        artifact = mask
    return artifact


def band_spectrogram(x: np.ndarray, fs: float):
    """Spectrogram frames at SPG_FS within FREQ_BOUNDS.

    Returns (frames [n_frames, n_freqs] or [n_frames, channels, n_freqs],
    freqs, frame_sample_indices)."""
    from scipy.signal import spectrogram as _spec

    nperseg = int(WINDOW_DURATION * fs)
    hop = int(fs / SPG_FS)
    f, t, Sxx = _spec(x, fs=fs, window="hann", nperseg=nperseg,
                      noverlap=nperseg - hop, axis=0, mode="magnitude")
    sel = (f >= FREQ_BOUNDS[0]) & (f <= FREQ_BOUNDS[1])
    Sxx = Sxx[sel]
    # Sxx: [freq, time] (1-D input) or [freq, channels, time] (2-D input)
    # -> time-leading: [time, freq] / [time, channels, freq].
    Sxx = np.moveaxis(Sxx, -1, 0)
    Sxx = np.moveaxis(Sxx, -1, 1) if Sxx.ndim == 3 else Sxx
    return Sxx, f[sel], (t * fs).astype(int)


def _zscore(x: np.ndarray, axis=0) -> np.ndarray:
    mu = x.mean(axis=axis, keepdims=True)
    sd = x.std(axis=axis, keepdims=True)
    return (x - mu) / np.maximum(sd, 1e-12)


def day_spectrograms(ecog: np.ndarray, audio: np.ndarray, fs: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Steps 1-2 of a day: the audio's [T, F] and the channels' [T, C, F]
    spectrogram frames, cut to a common length, artifact frames dropped."""
    artifact = detect_artifacts(ecog, fs)
    logger.info("%.2f%% artifact samples", 100 * artifact.mean())
    brain_spec, _, centers = band_spectrogram(ecog, fs)
    audio_spec, _, _ = band_spectrogram(audio, fs)
    T = min(len(brain_spec), len(audio_spec))
    keep = ~artifact[np.clip(centers[:T], 0, len(artifact) - 1)]
    return audio_spec[:T][keep], brain_spec[:T][keep]


def lagged_correlation_measure(audio_spec: np.ndarray, brain_spec: np.ndarray,
                               max_lag_frames: int):
    """(mean over (channel, freq) of max |corr| over lags, that max [C, F]);
    audio_spec [T, F], brain_spec [T, C, F].  The plain version of one
    surrogate on the audio spectrogram rolled by its shift."""
    T = audio_spec.shape[0]
    a = _zscore(audio_spec)
    b = _zscore(brain_spec)
    best = np.zeros(brain_spec.shape[1:])  # [C, F]
    for lag in range(-max_lag_frames, max_lag_frames + 1):
        if lag >= 0:
            aa, bb = a[lag:], b[:T - lag]
        else:
            aa, bb = a[:T + lag], b[-lag:]
        corr = np.abs(np.einsum("tf,tcf->cf", aa, bb) / max(len(aa), 1))
        best = np.maximum(best, corr)
    return float(best.mean()), best


def surrogate_shifts(T: int, max_lag_frames: int, n_surrogates: int,
                     seed: int = 0) -> np.ndarray:
    """The surrogates' circular shifts of the audio spectrogram, drawn
    beyond the lag window as the JAX package draws them."""
    min_shift = 2 * max_lag_frames + 1
    rng = np.random.default_rng(seed)
    return rng.integers(min_shift, T - min_shift, size=n_surrogates)


def surrogate_measures(audio_spec: np.ndarray, brain_spec: np.ndarray,
                       max_lag_frames: int, n_surrogates: int,
                       seed: int = 0, device=None) -> np.ndarray:
    """The permutation distribution [n_surrogates] float32:
    ``lagged_correlation_measure`` of the audio spectrogram rolled by each
    of ``surrogate_shifts``, on ``device`` (cuda unless asked otherwise).

    Rolled by s, lag l correlates audio frame (u + l - s) mod T with brain
    frame u over u in [max(0, -l), T - max(0, l)).  A chunk of shifts
    gathers G[f, k, j] = a[(j - L - s_k) mod T, f] once (L the largest
    lag); lag l is then the slice j = u + l + L of G, and one batched
    product [F, K, n] x [F, n, C] per lag gives every (shift, channel,
    frequency) correlation of the chunk."""
    dev = resolve_device(device)
    T = audio_spec.shape[0]
    L = max_lag_frames
    shifts = torch.as_tensor(surrogate_shifts(T, L, n_surrogates, seed),
                             device=dev)
    a = torch.as_tensor(_zscore(audio_spec).T, dtype=torch.float32,
                        device=dev)                            # [F, T]
    b = torch.as_tensor(np.ascontiguousarray(_zscore(brain_spec).transpose(
        2, 0, 1)), dtype=torch.float32, device=dev)             # [F, T, C]
    j = torch.arange(T + 2 * L, device=dev)
    out = []
    for i in range(0, n_surrogates, SURROGATE_CHUNK):
        s = shifts[i:i + SURROGATE_CHUNK]
        G = a[:, (j[None, :] - L - s[:, None]) % T]            # [F, K, T+2L]
        best = torch.zeros((b.shape[0], s.shape[0], b.shape[2]),
                           device=dev)                          # [F, K, C]
        for lag in range(-L, L + 1):
            lo, hi = max(0, -lag), T - max(0, lag)
            corr = torch.bmm(G[:, :, lo + lag + L:hi + lag + L], b[:, lo:hi])
            best = torch.maximum(best, (corr / (hi - lo)).abs())
        out.append(best.mean(dim=(0, 2)))
    return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.float32)


def analyze_day(agg_file: Path, out_path: Path, nb_surrogates: int = None,
                device=None) -> dict:
    """The permutation test of one ``*_KeywordReading_Overt.mat`` day
    (``fs``, ``ecog`` [N, C], ``audio`` [N]) -> ``{day}_contamination_result
    .mat`` in ``out_path``; returns its ``out`` dict."""
    mat = loadmat(agg_file.as_posix(), simplify_cells=True)
    fs = float(mat["fs"])
    ecog = np.asarray(mat["ecog"], np.float64)
    audio = np.asarray(mat["audio"], np.float64).reshape(-1)
    audio_spec, brain_spec = day_spectrograms(ecog, audio, fs)

    max_lag_frames = int(MAX_TIME_LAG * SPG_FS)
    dataset_measure, _ = lagged_correlation_measure(
        audio_spec, brain_spec, max_lag_frames)
    surrogates = surrogate_measures(
        audio_spec, brain_spec, max_lag_frames,
        NB_SURROGATES if nb_surrogates is None else nb_surrogates,
        device=device)
    criterion = float((surrogates >= dataset_measure).mean())

    day = agg_file.name.split("_KeywordReading")[0]
    out = dict(surrogate_measures=surrogates.astype(np.float32),
               dataset_measure=np.float32(dataset_measure),
               criterion_value=np.float32(criterion))
    savemat(os.path.join(out_path.as_posix(),
                         f"{day}_contamination_result.mat"), dict(out=out))
    logger.info("%s: measure=%.4f, P=%.4f", day, dataset_measure, criterion)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Run the acoustic-contamination permutation analysis "
                    "(PyTorch port of the Roussel pipeline).")
    parser.add_argument("--agg-path", required=True,
                        help="Directory with aggregated per-day .mat files.")
    parser.add_argument("--out", required=True, help="Results directory.")
    parser.add_argument("--device", default=None,
                        help="Torch device of the surrogates (default: "
                             "cuda).")
    args = parser.parse_args(argv)
    out_path = Path(args.out)
    os.makedirs(out_path.as_posix(), exist_ok=True)
    for agg_file in sorted(Path(args.agg_path).glob(
            "*_KeywordReading_Overt.mat")):
        analyze_day(agg_file, out_path, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        datefmt="%d.%m.%y %H:%M:%S")
    main()
