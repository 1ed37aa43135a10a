"""Vocoder audio-quality metrics (counterpart of dss_tpu/eval/quality.py).

Audio is scored against a reference waveform in the vocoder's own analysis
domain: the 18 Bark-scale cepstra of the port's ``LPCFeatureEncoder``
(``vocoder/features.py``), inverted to log band energies with
``vocoder/lpc.py::DCT_MATRIX``.  The metric follows the envelope the
vocoder has to carry and ignores phase, which no LPC vocoder keeps.

``cepstral_distance``     mean log-spectral distance (dB) over the 18 Bark
                          bands, framewise over aligned 10 ms frames, band
                          energies floored 20 dB below each frame's peak.
``band_level_snr``        SNR (dB) of the floored log band energies.
``score``                 both, with the frame count.
``stoi``                  Short-Time Objective Intelligibility (Taal et al.
                          2011), numpy and scipy.
``dtw_cepstral_distance`` path-normalized DTW distance of two waveforms'
                          cepstra; ``keyword_id_report`` and
                          ``keyword_id_accuracy`` classify resynthesized
                          keywords by it against the originals.
``score_roundtrip``       encode -> synthesize -> score, the standing check
                          of a vocoder backend.

All accept int16 or float [-1, 1] PCM at 16 kHz.  The functions that
encode audio take ``device`` for the encoder (the card unless the caller
asks for another); the rest is host numpy, as in the JAX package.
"""


from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from ..vocoder.features import LPCFeatureEncoder
from ..vocoder.lpc import DCT_MATRIX, NB_BANDS

# Bands more than this far below the frame's peak band are floored before
# the distance is taken (they carry no perceptual envelope information, and
# their log energies are numerically unstable for spectrally sparse audio).
_FLOOR_DB = 20.0


def _to_float(audio: np.ndarray) -> np.ndarray:
    audio = np.asarray(audio)
    if np.issubdtype(audio.dtype, np.integer):
        return audio.astype(np.float32) / 32768.0
    return audio.astype(np.float32)


def _log_bands(audio: np.ndarray, device=None) -> np.ndarray:
    """[T] PCM -> [N, 18] floored log10 band energies via the encoder.

    The encoder emits cepstra (DCT of log10 band energies,
    vocoder/lpc.py::cepstrum_from_bands); the DCT is inverted here and a
    per-frame dynamic floor applied.
    """
    enc = LPCFeatureEncoder(device=device)
    feats = enc.compute_LPC_features(_to_float(audio))
    log_e = feats[:, :NB_BANDS] @ DCT_MATRIX  # invert the orthonormal DCT
    peak = np.max(log_e, axis=1, keepdims=True)
    return np.maximum(log_e, peak - _FLOOR_DB / 10.0)


class QualityReport(NamedTuple):
    cepstral_distance_db: float   # mean MCD over frames (lower is better)
    band_level_snr_db: float      # envelope SNR (higher is better)
    num_frames: int


def _aligned_log_bands(reference, synthesized, skip_frames, device):
    lb_ref = _log_bands(reference, device)
    lb_syn = _log_bands(synthesized, device)
    n = min(len(lb_ref), len(lb_syn))
    if n <= skip_frames:
        raise ValueError(f"need more than {skip_frames} frames, got {n}")
    return lb_ref[skip_frames:n], lb_syn[skip_frames:n]


def cepstral_distance(reference: np.ndarray, synthesized: np.ndarray,
                      skip_frames: int = 2, device=None) -> float:
    """Mean log-spectral distance (dB) over Bark bands between waveforms.

    Per frame: ``sqrt(mean_b (10 * dlog10 E_b)^2)``, then averaged over
    frames.  ``skip_frames`` leading frames are excluded: the synthesis
    filter and the encoder history both start from silence, so the first
    frames compare transients, not steady-state quality.
    """
    lb_ref, lb_syn = _aligned_log_bands(reference, synthesized, skip_frames,
                                         device)
    d_db = 10.0 * (lb_ref - lb_syn)
    return float(np.mean(np.sqrt(np.mean(d_db * d_db, axis=1))))


def band_level_snr(reference: np.ndarray, synthesized: np.ndarray,
                   skip_frames: int = 2, device=None) -> float:
    """SNR (dB) of floored log band energies (mean-removed per signal)."""
    lb_ref, lb_syn = _aligned_log_bands(reference, synthesized, skip_frames,
                                         device)
    sig = lb_ref - lb_ref.mean()
    err = lb_ref - lb_syn
    return 10.0 * math.log10(
        max(float(np.sum(sig * sig)), 1e-12)
        / max(float(np.sum(err * err)), 1e-12)
    )


def score(reference: np.ndarray, synthesized: np.ndarray,
          skip_frames: int = 2, device=None) -> QualityReport:
    lb_ref, lb_syn = _aligned_log_bands(reference, synthesized, skip_frames,
                                         device)
    d_db = 10.0 * (lb_ref - lb_syn)
    lsd = float(np.mean(np.sqrt(np.mean(d_db * d_db, axis=1))))
    sig = lb_ref - lb_ref.mean()
    err = lb_ref - lb_syn
    snr = 10.0 * math.log10(
        max(float(np.sum(sig * sig)), 1e-12)
        / max(float(np.sum(err * err)), 1e-12)
    )
    return QualityReport(cepstral_distance_db=lsd, band_level_snr_db=snr,
                         num_frames=len(lb_ref))


# ---------------------------------------------------------------------------
# STOI — Short-Time Objective Intelligibility (Taal et al., ICASSP 2011).
#
# Pipeline (all constants from the paper): resample to 10 kHz; drop silent
# frames (> 40 dB below the loudest reference frame); 256-sample Hann STFT
# with 50% overlap, 512-point FFT; 15 one-third-octave bands from 150 Hz;
# short-time (30-frame = 384 ms) envelope vectors, normalized + clipped at
# -15 dB SDR; averaged band/segment correlation.
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_FRAME = 256
_STOI_HOP = 128
_STOI_NFFT = 512
_STOI_BANDS = 15
_STOI_MINFREQ = 150.0
_STOI_N = 30          # envelope-segment length in frames (384 ms)
_STOI_BETA = -15.0    # SDR clipping (dB)
_STOI_DYN = 40.0      # silent-frame threshold below peak frame (dB)


def _third_octave_matrix() -> np.ndarray:
    """[15, 257] 0/1 selection matrix of one-third-octave bands."""
    f = np.linspace(0, _STOI_FS / 2, _STOI_NFFT // 2 + 1)
    cf = _STOI_MINFREQ * 2.0 ** (np.arange(_STOI_BANDS) / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    return ((f[None, :] >= lo[:, None]) & (f[None, :] < hi[:, None])
            ).astype(np.float64)


def _stoi_frames(x: np.ndarray) -> np.ndarray:
    n = 1 + max(0, (len(x) - _STOI_FRAME)) // _STOI_HOP
    idx = (np.arange(_STOI_FRAME)[None, :]
           + _STOI_HOP * np.arange(n)[:, None])
    return x[idx] * np.hanning(_STOI_FRAME)[None, :]


def stoi(reference: np.ndarray, synthesized: np.ndarray,
         fs: int = 16000) -> float:
    """Short-Time Objective Intelligibility of ``synthesized`` given
    ``reference`` (0..1; ~0.75+ is typically 'intelligible' speech)."""
    from scipy.signal import resample_poly

    x = _to_float(reference).astype(np.float64)
    y = _to_float(synthesized).astype(np.float64)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    if fs != _STOI_FS:
        g = math.gcd(fs, _STOI_FS)
        x = resample_poly(x, _STOI_FS // g, fs // g)
        y = resample_poly(y, _STOI_FS // g, fs // g)

    xf, yf = _stoi_frames(x), _stoi_frames(y)
    if len(xf) < _STOI_N:
        raise ValueError(f"need >= {_STOI_N} frames for STOI, got {len(xf)}")
    # Silent-frame removal keyed on the REFERENCE frame energies.
    e = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = e >= (e.max() - _STOI_DYN)
    xf, yf = xf[keep], yf[keep]
    if len(xf) < _STOI_N:
        raise ValueError("fewer than 30 active frames after VAD")

    spec_x = np.abs(np.fft.rfft(xf, _STOI_NFFT, axis=1)) ** 2
    spec_y = np.abs(np.fft.rfft(yf, _STOI_NFFT, axis=1)) ** 2
    octs = _third_octave_matrix()
    bx = np.sqrt(spec_x @ octs.T)     # [M, 15] band envelopes
    by = np.sqrt(spec_y @ octs.T)

    # Short-time segments: sliding windows of N frames.
    M = len(bx) - _STOI_N + 1
    win = (np.arange(_STOI_N)[None, :] + np.arange(M)[:, None])
    sx = bx[win]                      # [M, N, 15]
    sy = by[win]
    # Normalize y to x's energy per (segment, band), then clip.
    nx = np.linalg.norm(sx, axis=1, keepdims=True)
    ny = np.linalg.norm(sy, axis=1, keepdims=True)
    alpha = nx / np.maximum(ny, 1e-12)
    sy_n = np.minimum(sy * alpha, sx * (1.0 + 10.0 ** (-_STOI_BETA / 20.0)))
    # Correlation coefficient per (segment, band).
    sx_c = sx - sx.mean(axis=1, keepdims=True)
    sy_c = sy_n - sy_n.mean(axis=1, keepdims=True)
    num = np.sum(sx_c * sy_c, axis=1)
    den = (np.linalg.norm(sx_c, axis=1) * np.linalg.norm(sy_c, axis=1))
    d = num / np.maximum(den, 1e-12)
    return float(np.mean(d))


# ---------------------------------------------------------------------------
# Keyword identification accuracy — intelligibility over the deployed
# vocabulary.  Each resynthesized keyword is classified by minimum
# DTW-aligned Bark-cepstral distance against the set of originals; accuracy
# is the fraction classified as themselves (chance = 1/6 for the reference
# system's six keywords).
# ---------------------------------------------------------------------------


def _cepstra(audio: np.ndarray, device=None) -> np.ndarray:
    """[T] PCM -> [N, 17] level-invariant cepstra (c0 dropped)."""
    enc = LPCFeatureEncoder(device=device)
    feats = enc.compute_LPC_features(_to_float(audio))
    return feats[:, 1:NB_BANDS].astype(np.float64)


def dtw_cepstral_distance(a: np.ndarray, b: np.ndarray, device=None) -> float:
    """Path-length-normalized DTW distance between two waveforms'
    Bark-cepstral sequences (Euclidean local cost)."""
    ca, cb = _cepstra(a, device), _cepstra(b, device)
    if not len(ca) or not len(cb):
        raise ValueError("empty cepstral sequence")
    # Local cost matrix [Ta, Tb].
    d = np.sqrt(np.maximum(
        (ca * ca).sum(1)[:, None] + (cb * cb).sum(1)[None, :]
        - 2.0 * (ca @ cb.T), 0.0))
    Ta, Tb = d.shape
    acc = np.full((Ta + 1, Tb + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, Ta + 1):
        prev = np.minimum(acc[i - 1, 1:], acc[i - 1, :-1])  # up, diag
        row = acc[i]
        row[0] = np.inf
        c = d[i - 1]
        for j in range(1, Tb + 1):
            row[j] = c[j - 1] + min(prev[j - 1], row[j - 1])
    return float(acc[Ta, Tb] / (Ta + Tb))


def keyword_id_report(originals: dict, resyntheses: dict, device=None
                      ) -> dict:
    """Full classification report for keyword identification.

    Each resynthesis (word -> waveform or list) is classified by minimum
    DTW cepstral distance against every word's original(s).  Returns::

        {"accuracy": float,
         "confusion": {true_word: {predicted_word: count}},
         "margins": [{"word", "predicted", "own_d", "best_other_word",
                      "best_other_d", "margin"} ...]}

    ``margin`` is ``best_other_d - own_d`` (positive = correctly and
    confidently classified; near zero = one confusable pair away from an
    error — 12/12 accuracy alone cannot distinguish the two)."""
    ref = {w: v if isinstance(v, (list, tuple)) else [v]
           for w, v in originals.items()}
    total, correct = 0, 0
    confusion = {w: {} for w in ref}
    margins = []
    for word, syns in resyntheses.items():
        for syn in (syns if isinstance(syns, (list, tuple)) else [syns]):
            dists = {cand: min(dtw_cepstral_distance(v, syn, device)
                               for v in variants)
                     for cand, variants in ref.items()}
            best_word = min(dists, key=dists.get)
            others = {c: d for c, d in dists.items() if c != word}
            best_other = min(others, key=others.get) if others else None
            total += 1
            correct += int(best_word == word)
            # A resynthesis word absent from the originals (e.g. a typo'd
            # --syn-dir entry) is counted as a classification error, not a
            # crash: mirror the margins path's tolerance of unknown words.
            row_counts = confusion.setdefault(word, {})
            row_counts[best_word] = row_counts.get(best_word, 0) + 1
            row = {"word": word, "predicted": best_word,
                   "own_d": round(dists.get(word, float("nan")), 4)}
            if best_other is not None:
                row["best_other_word"] = best_other
                row["best_other_d"] = round(others[best_other], 4)
                if word in dists:
                    # Unknown-word rows get no margin key: a NaN here
                    # would poison np.min/np.median margin summaries
                    # downstream.
                    row["margin"] = round(others[best_other]
                                          - dists[word], 4)
            margins.append(row)
    if total == 0:
        raise ValueError("no resyntheses given")
    return {"accuracy": correct / total, "confusion": confusion,
            "margins": margins}


def keyword_id_accuracy(originals: dict, resyntheses: dict, device=None
                        ) -> float:
    """Fraction of ``resyntheses`` (word -> waveform or list of waveforms)
    whose DTW cepstral distance is minimal to their own word's original.

    ``originals`` maps each word to one reference waveform (or a list —
    the minimum over variants is used)."""
    return keyword_id_report(originals, resyntheses, device)["accuracy"]


def score_roundtrip(audio: np.ndarray, vocoder, device=None) -> QualityReport:
    """Encode ``audio``, synthesize with ``vocoder``, score against input.

    ``vocoder`` is any object with the LPCNet ``synthesize_frames`` (or
    per-frame ``synthesize``) contract: [T, 20] float32 -> int16 [T*160].
    """
    enc = LPCFeatureEncoder(device=device)
    feats = enc.compute_LPC_features(_to_float(audio))
    if hasattr(vocoder, "synthesize_frames"):
        pcm = vocoder.synthesize_frames(feats)
    else:
        pcm = np.concatenate([vocoder.synthesize(f) for f in feats])
    n = min(len(pcm), len(_to_float(audio)))
    return score(_to_float(audio)[:n], pcm[:n], device=device)
