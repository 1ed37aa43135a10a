"""Per-channel spectrogram change against the SyllableRepetition baseline
(counterpart of eval/suppl_fig_2.py, supplementary figure 2).

For every electrode: the speech-onset-aligned, trial-averaged spectrogram
(50 ms Hann windows at a 10 ms hop, 100 FFT bins, 0.5 s before to 1.5 s
after onset; the onset from the energy VAD on the audio channel),
normalized in dB against the channel's mean spectrum over the day's
SyllableRepetition trials, laid out on the two 8x8 grids with the bad
channels framed in red.

The computation and the drawing are apart: ``spectral_change`` returns the
arrays (the spectrograms are batched FFTs over every channel and window of
a trial, on the device; loading and the energy VAD stay on the host), and
``draw`` renders them.  matplotlib is imported only inside ``draw``: where
it is not installed the arrays are still computed and saved, and no figure
is claimed.

    python -m dss_tpu_torch.eval.suppl_fig_2 KEYWORD.mat BASELINE.mat \
        [--keyword WORD] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from scipy.io import loadmat

from ..device import resolve_device
from ..ops.mel import EnergyBasedVad
from ..utils.bci2000 import ExperimentMapping
from ..utils.channels import SelectElectrodesFromBothGrids

logger = logging.getLogger("suppl_fig_2.py")

WINDOW_SIZE = 0.05
NB_FFT_BINS = 100
PRE_ONSET = 0.5
POST_ONSET = 1.5
BAD_CHANNELS = (19, 38, 48, 52)  # 1-based, framed in red


def _load(mat_path: Path):
    mat = loadmat(mat_path.as_posix(), simplify_cells=True)
    sel = SelectElectrodesFromBothGrids()
    gain = mat["parameters"]["SourceChGain"]["NumericValue"]
    signals = sel(mat["signal"] * gain)
    audio = mat["signal"][:, 128] * gain[128]
    fs = mat["parameters"]["SamplingRate"]["NumericValue"]
    cls = ExperimentMapping.get_experiment_class(mat_filename=str(mat_path))
    experiment = cls(mat["states"]["StimulusCode"],
                     ExperimentMapping.extract_stimuli_values(mat))
    return signals, audio, fs, experiment


def spectrograms(segment: torch.Tensor, fs: float) -> torch.Tensor:
    """PSD spectrograms of every channel of ``segment`` [L, C] (float64)
    -> [C, NB_FFT_BINS // 2 + 1, windows]: scipy.signal.spectrogram's
    defaults (periodic Hann, constant detrend, one-sided density) at
    50 ms windows and a 10 ms hop, zero-padded to NB_FFT_BINS."""
    n = int(WINDOW_SIZE * fs)
    step = n - int(WINDOW_SIZE * fs - 0.01 * fs)
    frames = segment.T.unfold(-1, n, step)                  # [C, W, n]
    frames = frames - frames.mean(-1, keepdim=True)
    k = torch.arange(n, dtype=segment.dtype, device=segment.device)
    win = 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)
    spec = torch.fft.rfft(frames * win, n=NB_FFT_BINS)
    psd = (spec.real ** 2 + spec.imag ** 2) / (fs * (win * win).sum())
    psd[..., 1:NB_FFT_BINS // 2] *= 2.0    # even nfft: DC and Nyquist once
    return psd.transpose(1, 2)


def spectral_change(mat_file: Path, cal_file: Path,
                    keyword: Optional[str] = None, device=None) -> dict:
    """The figure's arrays: ``chan_specs`` [channels, 51, windows] float32
    (dB against the baseline; zeros where no trial spans the window),
    ``norm_stats`` [channels, 51] float32 (the baseline spectra),
    ``onsets`` (VAD onset frame of each keyword trial) and ``trials_used``
    (trials whose window fits their segment)."""
    dev = resolve_device(device)
    cal_signals, _, cal_fs, cal_exp = _load(cal_file)
    mat_signals, mat_audio, mat_fs, mat_exp = _load(mat_file)
    n_chan = cal_signals.shape[1]
    n_bins = NB_FFT_BINS // 2 + 1

    # Baseline spectrum per channel over the calibration recording's trials.
    cal = torch.as_tensor(cal_signals, dtype=torch.float64, device=dev)
    total = torch.zeros((n_chan, n_bins), dtype=torch.float64, device=dev)
    frames = 0
    for _, start, stop in cal_exp.get_trial_indices():
        spec = spectrograms(cal[start:stop], cal_fs)
        total += spec.sum(-1)
        frames += spec.shape[-1]
    norm_stats = (total / frames).to(torch.float32)

    nb_pre = math.floor((PRE_ONSET * mat_fs - WINDOW_SIZE * mat_fs)
                        / (0.01 * mat_fs)) + 5
    nb_post = math.floor((POST_ONSET * mat_fs - WINDOW_SIZE * mat_fs)
                         / (0.01 * mat_fs)) + 5

    mat_trials = [t for t in mat_exp.get_trial_indices()
                  if keyword is None or t[0] == keyword]
    onsets = []
    for label, start, stop in mat_trials:
        audio_segment = mat_audio[start:int(stop + POST_ONSET * mat_fs)]
        vad_labels = EnergyBasedVad().from_wav(audio_segment,
                                               sampling_rate=mat_fs)
        onsets.append(int(np.argmax(vad_labels)))

    signals = torch.as_tensor(mat_signals, dtype=torch.float64, device=dev)
    trial_specs = []
    for (label, start, stop), onset in zip(mat_trials, onsets):
        spec = spectrograms(signals[start:int(stop + POST_ONSET * mat_fs)],
                            mat_fs)
        lo, hi = onset - nb_pre, onset + nb_post
        if lo < 0 or hi > spec.shape[-1]:
            continue
        trial_specs.append(spec[..., lo:hi])

    chan_specs = torch.zeros((n_chan, n_bins, nb_pre + nb_post),
                             dtype=torch.float32, device=dev)
    if trial_specs:
        mean_spec = torch.stack(trial_specs).mean(0)
        baseline = norm_stats.clamp_min(1e-20).double()[:, :, None]
        chan_specs = (10.0 * torch.log10(mean_spec.clamp_min(1e-20)
                                         / baseline)).to(torch.float32)
    return dict(chan_specs=chan_specs.cpu().numpy(),
                norm_stats=norm_stats.cpu().numpy(),
                onsets=np.asarray(onsets, np.int64),
                trials_used=len(trial_specs))


def grid_layout() -> np.ndarray:
    """[17, 8] channel index of each panel: the motor grid (65..128) on
    top, a spacer row (NaN), the speech grid (1..64) below."""
    upper = np.flip(np.flip((np.arange(64) + 64).reshape(8, 8)), axis=1)
    lower = np.flip(np.flip(np.arange(64).reshape(8, 8)), axis=1)
    return np.concatenate([upper, np.full((1, 8), np.nan), lower])


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def draw(chan_specs: np.ndarray, out_dir: Optional[Path] = None
         ) -> Optional[Path]:
    """Render ``chan_specs`` on the grid layout as ``suppl_fig_2.png`` in
    ``out_dir``; returns its path, or None where matplotlib is missing."""
    plt = _pyplot()
    if plt is None:
        return None
    layout = grid_layout()
    height_ratios = np.ones(17)
    height_ratios[8] = 0.25
    fig, axes = plt.subplots(nrows=17, ncols=8,
                             gridspec_kw={"height_ratios": height_ratios},
                             figsize=(8.5, 10))
    for (row, col) in np.ndindex(layout.shape):
        ax = axes[row, col]
        ax.set_xticks([])
        ax.set_yticks([])
        idx = layout[row, col]
        if np.isnan(idx):
            for side in ("top", "bottom", "left", "right"):
                ax.spines[side].set_visible(False)
            continue
        idx = int(idx)
        ax.imshow(chan_specs[idx], aspect="auto", origin="lower",
                  cmap="RdBu_r", vmin=-5, vmax=5)
        if (idx + 1) in BAD_CHANNELS:
            for side in ("top", "bottom", "left", "right"):
                ax.spines[side].set_color("red")
                ax.spines[side].set_linewidth(2)

    plt.tight_layout()
    out = (out_dir or Path(".")) / "suppl_fig_2.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out.as_posix(), dpi=200)
    plt.close(fig)
    return out


def gen_power_spectral_analysis_figure(mat_file: Path, cal_file: Path,
                                       keyword: Optional[str] = None,
                                       out_dir: Optional[Path] = None,
                                       device=None) -> dict:
    """``spectral_change``, its arrays saved as ``suppl_fig_2.npz`` in
    ``out_dir``, then ``draw``.  Returns the arrays with ``arrays_path``
    and ``figure`` (the PNG's path, or None where matplotlib is missing)."""
    arrays = spectral_change(Path(mat_file), Path(cal_file), keyword, device)
    out = Path(out_dir or ".")
    out.mkdir(parents=True, exist_ok=True)
    arrays_path = out / "suppl_fig_2.npz"
    np.savez(arrays_path, **arrays)
    figure = draw(arrays["chan_specs"], out)
    if figure is None:
        logger.warning("matplotlib is not installed: suppl_fig_2.png not "
                       "drawn; the arrays are in %s", arrays_path)
    else:
        logger.info("Wrote %s and %s", figure, arrays_path)
    return dict(arrays, arrays_path=arrays_path, figure=figure)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Per-channel spectrogram change vs baseline figure.")
    parser.add_argument("mat_file", help="KeywordReading recording .mat")
    parser.add_argument("cal_file", help="SyllableRepetition baseline .mat")
    parser.add_argument("--keyword", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default=None,
                        help="Torch device of the spectrograms (default: "
                             "cuda).")
    args = parser.parse_args(argv)
    return gen_power_spectral_analysis_figure(
        Path(args.mat_file), Path(args.cal_file), keyword=args.keyword,
        out_dir=Path(args.out) if args.out else None, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        datefmt="%d.%m.%y %H:%M:%S",
    )
    main()
