"""Mel filterbank and Kaldi-style energy VAD for corpus preparation (the
port's own copy of dss_tpu/ops/mel.py: host numpy and scipy, as there — the
labels are computed once per trial, on the CPU, from int16 audio).

What it reproduces: reference local/common.py:475-553 (triangular mel
filterbank with a normalized-transpose inverse and log-mel helpers) and :556-671 (energy
VAD): wav -> hann/rFFT spectrogram (50 ms window, 10 ms shift, /2^15 scaling)
-> 40 log-mels -> DCT-II MFCCs -> threshold ``scale * mean(MFCC0) + thr``
with an asymmetric [t-5, t+5) context window and 0.6 proportion; ``.lab``
export.

The implementation here is vectorized numpy (no per-band / per-frame Python
loops); only the *numbers* match the reference, which defines the training
labels.  The reference's camelCase method names are kept as aliases so code
migrating from ``local.common`` keeps working (see MIGRATION.md).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.fftpack import dct


def hz_to_mel(freq: float) -> float:
    """O'Shaughnessy mel scale (the variant the labels were built with)."""
    return 2595.0 * math.log10(1.0 + freq / 700.0)


def mel_to_hz(mel: np.ndarray) -> np.ndarray:
    return 700.0 * (np.power(10.0, np.asarray(mel) / 2595.0) - 1.0)


def _zap_nonfinite(x: np.ndarray) -> np.ndarray:
    """Replace NaN/Inf in-place with 0 and return the array."""
    x[~np.isfinite(x)] = 0.0
    return x


class MelFilterBank:
    """Triangular mel filterbank with a normalized-transpose inverse.

    Band edges are laid out uniformly on the mel axis between 0 and
    ``hz_to_mel(sample_rate / 2)``, snapped to spectrogram bins via
    ``floor(hz) / (sr/2) * spec_size`` (two nested floors — an idiosyncrasy
    of the label-generating code that must be preserved for parity).  The
    forward matrix is column-normalized; the "inverse" is the normalized
    transpose, good enough for the coarse spectral envelopes the VAD needs.
    """

    def __init__(self, spec_size: int, num_bands: int, sample_rate: float):
        num_bands = int(num_bands)
        self.spec_size = int(spec_size)
        self.num_bands = num_bands
        self.sample_rate = float(sample_rate)

        mel_edges = np.arange(num_bands + 2) * (
            hz_to_mel(sample_rate / 2.0) / (num_bands + 1)
        )
        hz_edges = np.floor(mel_to_hz(mel_edges))
        bin_edges = np.floor(hz_edges / (sample_rate / 2.0) * spec_size).astype(int)

        lo = bin_edges[:-2, None]    # [bands, 1] triangle start bin
        mid = bin_edges[1:-1, None]  # triangle peak bin
        hi = bin_edges[2:, None]     # triangle end bin (exclusive)
        bins = np.arange(spec_size)[None, :]

        with np.errstate(divide="ignore", invalid="ignore"):
            rising = (bins - lo) / (mid - lo).astype(float)
            falling = (hi - bins) / (hi - mid).astype(float)
        tri = np.where(
            (bins >= lo) & (bins < mid), rising,
            np.where((bins >= mid) & (bins < hi), falling, 0.0),
        )
        tri = _zap_nonfinite(tri)  # degenerate (zero-width) triangle slopes

        self.forward = _zap_nonfinite(tri.T / self._safe_colsum(tri.T))
        self.inverse = _zap_nonfinite(self.forward.T / self._safe_colsum(self.forward.T))

    @staticmethod
    def _safe_colsum(x: np.ndarray) -> np.ndarray:
        s = x.sum(axis=0)
        return np.where(s == 0.0, 1.0, s)

    # -- core API ----------------------------------------------------------
    def to_mels(self, spectrogram: np.ndarray) -> np.ndarray:
        return spectrogram @ self.forward

    def from_mels(self, mel_spectrogram: np.ndarray) -> np.ndarray:
        return mel_spectrogram @ self.inverse

    def to_log_mels(self, spectrogram: np.ndarray) -> np.ndarray:
        return _zap_nonfinite(np.log(self.to_mels(spectrogram) + 1e-7))

    def from_log_mels(self, log_mel_spectrogram: np.ndarray) -> np.ndarray:
        return _zap_nonfinite(self.from_mels(np.exp(log_mel_spectrogram)))

    # -- reference-surface aliases (MIGRATION.md) --------------------------
    @property
    def melMatrix(self) -> np.ndarray:  # noqa: N802
        return self.forward

    @property
    def melInvMatrix(self) -> np.ndarray:  # noqa: N802
        return self.inverse

    toMels = to_mels
    fromMels = from_mels
    toMelScale = to_mels
    fromMelScale = from_mels
    toLogMels = to_log_mels
    fromLogMels = from_log_mels


class EnergyBasedVad:
    """Kaldi-compute-vad-equivalent energy VAD on MFCC0."""

    def __init__(self, energy_threshold: float = 4,
                 energy_mean_scale: float = 1, frames_context: int = 5,
                 proportion_threshold: float = 0.6):
        self.vad_energy_threshold = energy_threshold
        self.vad_energy_mean_scale = energy_mean_scale
        self.vad_frames_context = frames_context
        self.vad_proportion_threshold = proportion_threshold
        self.mfcc_coeff = 13
        self.frame_shift = 0.01
        self.window_length = 0.05

    def from_wav(self, wav: np.ndarray, sampling_rate: int = 16000) -> np.ndarray:
        window_size = int(sampling_rate * self.window_length)
        window_shift = int(sampling_rate * self.frame_shift)
        nb_windows = math.floor((len(wav) - window_size) / window_shift) + 1

        starts = (np.arange(nb_windows) * window_shift).astype(int)
        idx = starts[:, None] + np.arange(window_size)[None, :]
        segments = np.asarray(wav)[idx] / (2 ** 15)

        win = np.hanning(window_size)
        spectrogram = np.fft.rfft(win * segments, axis=1)

        mfb = MelFilterBank(spectrogram.shape[1], 40, sampling_rate)
        log_mels = mfb.to_log_mels(np.abs(spectrogram))
        return self.from_log_mels(log_mels=log_mels)

    def from_log_mels(self, log_mels: np.ndarray) -> np.ndarray:
        self.mfccs = dct(log_mels)[:, : self.mfcc_coeff + 2]
        return self.from_mfccs(self.mfccs)

    def from_mfccs(self, mfccs: np.ndarray) -> np.ndarray:
        self.mfccs = mfccs
        return self._compute_vad()

    def _compute_vad(self) -> np.ndarray:
        log_energy = self.mfccs[:, 0]
        n = len(self.mfccs)

        energy_threshold = self.vad_energy_threshold
        if self.vad_energy_mean_scale != 0:
            assert self.vad_energy_mean_scale > 0
            energy_threshold += self.vad_energy_mean_scale * \
                np.sum(log_energy) / n

        assert self.vad_frames_context >= 0
        assert 0.0 < self.vad_proportion_threshold < 1

        # Asymmetric context window [t - ctx, t + ctx), clipped to the
        # signal, judged by proportion of above-threshold frames.  Windowed
        # counts via a prefix sum — no per-frame loop.
        ctx = self.vad_frames_context
        above = (log_energy > energy_threshold).astype(np.int64)
        prefix = np.concatenate([[0], np.cumsum(above)])
        t = np.arange(n)
        lo = np.maximum(0, t - ctx)
        hi = np.minimum(n, t + ctx)
        counts = prefix[hi] - prefix[lo]
        return counts >= (hi - lo) * self.vad_proportion_threshold

    def convert_vad_to_lab(self, filename: str, vad: np.ndarray) -> None:
        last_i = None
        s = None
        rows = ""
        for t, i in enumerate(vad):
            if last_i is None:
                last_i = i
                s = 0
            if i != last_i:
                e = t * self.frame_shift
                rows += f"{s:.2f}\t{e:.2f}\t{int(last_i)}\n"
                s = t * self.frame_shift
                last_i = i
        rows += f"{s:.2f}\t{len(vad) * self.frame_shift:.2f}\t{int(last_i)}\n"
        with open(filename, "w+") as f:
            f.write(rows)
