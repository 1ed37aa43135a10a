"""Corpus preparation: features and targets from recorded sessions
(counterpart of apps/prepare_corpus.py).

Per (mat, wav) recording pair and per trial (min length 2.5 s, +0.04 s
pad):
  * high-gamma features: a fresh ``HighGammaExtractor`` per trial on the
    device (both-grid reorder + CAR, bad/contaminated channel patching when
    the recording flags contaminated channels) — on the card one launch of
    the front-end kernel per trial, at 128 channels and no carry;
  * LPC targets from the time-aligned wav through the port's
    ``LPCFeatureEncoder`` on the device (-3 dB peak normalization except
    SILENCE trials, 16 ms filter-delay shift, frames [3:-1]);
  * energy-VAD labels on the host (zeroed for SILENCE trials; a debug PNG
    per trial under ``<tempdir>/vad_labels`` when matplotlib imports);
  * sign-alternating trial ids;
  * z-scores from per-day SyllableRepetition statistics.
``prepare`` returns the corpus as dicts {hga_activity, lpc_coefficients,
vad_labels, trial_ids} keyed by output file; ``main`` writes each as an
HDF container (h5py needed, see utils/hdf.py).

    python -m dss_tpu_torch.apps.prepare_corpus OUT_DIR NORM_DIR FOLDER...
        [--device cpu]
"""

import argparse
import logging
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..device import resolve_device
from ..ops.car import BadChannelCorrection, CommonAverageReferencing
from ..ops.hga import HighGammaExtractor
from ..ops.mel import EnergyBasedVad
from ..utils.audio import peak_normalize, read_wav
from ..utils.bci2000 import BCI2000MatFile, ExperimentMapping
from ..utils.channels import SelectElectrodesFromBothGrids, default_layout, \
    motor_grid, speech_grid
from ..utils.hdf import save_data_to_hdf
from ..vocoder.features import LPCFeatureEncoder

logger = logging.getLogger("prepare_corpus.py")


def get_feature_extractor(cleaned_mat_file: BCI2000MatFile,
                          device=None) -> HighGammaExtractor:
    """Both-grids reorder + CAR pre-transforms; bad/contaminated channel
    patching post-transform when the recording flags contaminated
    channels."""
    fs = cleaned_mat_file.fs
    bad_channels = cleaned_mat_file.bad_channels()
    contaminated_channels = cleaned_mat_file.contaminated_channels()

    feature_selection = SelectElectrodesFromBothGrids()
    car = CommonAverageReferencing(
        exclude_channels=[19, 38, 48, 52],
        grids=[speech_grid(), motor_grid()],
        layout=default_layout(),
    )
    post_transforms = None
    if contaminated_channels is not None:
        logger.debug(
            f"Found contaminated channels in {cleaned_mat_file.mat_filename}: "
            f"{contaminated_channels}."
        )
        corrected = (bad_channels or []) + contaminated_channels
        post_transforms = [BadChannelCorrection(
            bad_channels=corrected, grids=[speech_grid(), motor_grid()],
            layout=default_layout(),
        )]

    return HighGammaExtractor(
        fs=fs, nb_electrodes=len(feature_selection),
        pre_transforms=[feature_selection, car],
        post_transforms=post_transforms, device=device,
    )


def trial_features(recording: BCI2000MatFile, trials, device=None
                   ) -> List[np.ndarray]:
    """High-gamma features of each trial span (padded by 0.04 s), each from
    a fresh extractor."""
    ecog = recording.signals()
    pad = 0.04 * recording.fs
    return [get_feature_extractor(recording, device).extract_features(
                ecog[start:int(stop + pad), :])
            for _, start, stop in trials]


class FeatureExtractionPipeline:
    """Extract features and targets from one (mat, wav) recording pair."""

    def __init__(self, mat_filename: Path, wav_filename: Path,
                 min_trial_length: Optional[float] = None,
                 vad_plot_dir: Optional[str] = None, device=None):
        self.mat_filename = mat_filename
        self.wav_filename = wav_filename
        self.min_trial_length = min_trial_length
        self.vad_plot_dir = vad_plot_dir or os.path.join(
            tempfile.gettempdir(), "vad_labels")
        self.device = resolve_device(device)
        self.mat = BCI2000MatFile(mat_filename=str(mat_filename))
        self.fs_audio, self.wav = read_wav(str(wav_filename))

    def _trials(self):
        return self.mat.trial_indices(self.min_trial_length)

    def _trial_audio(self, label: str, start: int, stop: int) -> np.ndarray:
        """Aligned, normalized, filter-delay-shifted trial audio."""
        start = int(start * self.fs_audio / self.mat.fs)
        stop = int(stop * self.fs_audio / self.mat.fs) + int(0.04 * self.fs_audio)
        trial_audio = self.wav[start:stop]
        if label != "SILENCE":
            trial_audio = peak_normalize(trial_audio, gain_db=-3.0)
        # Shift audio by 16 ms to account for the IIR filter group delay.
        pad = np.zeros(int(0.016 * self.fs_audio), dtype=np.int16)
        return np.hstack([pad, trial_audio[:-len(pad)]])

    def get_features(self) -> np.ndarray:
        return np.concatenate(trial_features(self.mat, self._trials(),
                                             self.device))

    def get_lpc_coefficients(self) -> np.ndarray:
        lpc_features = []
        for label, start, stop in self._trials():
            trial_audio = self._trial_audio(label, start, stop)
            encoder = LPCFeatureEncoder(device=self.device)
            features = encoder.compute_LPC_features(trial_audio)
            lpc_features.append(features[3:-1])
        return np.concatenate(lpc_features)

    def get_vad_labels(self) -> np.ndarray:
        vad_labels = []
        for i, (label, start, stop) in enumerate(self._trials()):
            trial_audio = self._trial_audio(label, start, stop)
            labels = EnergyBasedVad().from_wav(trial_audio,
                                               sampling_rate=self.fs_audio)
            if label == "SILENCE":
                labels = np.zeros_like(labels)
            vad_labels.append(labels)
            self._plot_vad(trial_audio, labels, i)
        return np.concatenate(vad_labels)

    def _plot_vad(self, trial_audio: np.ndarray, labels: np.ndarray,
                  index: int) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(1, 1, num=1, clear=True)
        xs = np.linspace(0, len(trial_audio) / self.fs_audio, len(trial_audio))
        peak = np.max(np.abs(trial_audio)) or 1
        ax.plot(xs, trial_audio / peak, c="blue")
        xs = np.linspace(0, len(trial_audio) / self.fs_audio, len(labels))
        ax.plot(xs, labels, c="orange")
        mat_path = Path(self.mat.mat_filename)
        out = Path(self.vad_plot_dir) / mat_path.parent.name / \
            f"{mat_path.with_suffix('').name}_{index + 1:03d}.png"
        os.makedirs(out.parent, exist_ok=True)
        plt.savefig(out.as_posix(), dpi=72)
        plt.close(fig)

    def get_trial_ids(self) -> np.ndarray:
        """Sign-alternating stimulus codes, one run per trial: consecutive
        trials of the same stimulus alternate sign so boundaries stay
        recoverable."""
        trial_ids = []
        stimuli = ExperimentMapping.extract_stimuli_values(self.mat.mat)

        last_code = None
        for label, start, stop in self._trials():
            interval = int(stop + (0.04 * self.mat.fs)) - start
            overlap = 0.04 * self.mat.fs
            window_shift = 0.01 * self.mat.fs
            num_windows = int(np.floor((interval - overlap) / window_shift))

            code = stimuli.index(label) + 1
            if last_code is None or last_code != code:
                trial_ids.append(np.ones(num_windows) * code)
                last_code = code
            else:
                trial_ids.append(np.ones(num_windows) * code * -1)
                last_code = -code
        return np.hstack(trial_ids).astype(np.int16)

    def accumulative_audio_duration(self) -> float:
        total = sum(stop - start for _, start, stop in self._trials())
        return total / self.mat.fs


class ZScoresFromSyllableRepetitions(dict):
    """day -> (mean, std) of high-gamma features over SyllableRepetition
    recordings."""

    def __init__(self, syllable_recordings: Dict[str, Path], device=None):
        super().__init__()
        for day, path in syllable_recordings.items():
            recording = BCI2000MatFile(mat_filename=path.as_posix())
            data = np.concatenate(trial_features(
                recording, recording.trial_indices(), device))
            self[day] = (np.mean(data, axis=0), np.std(data, axis=0))


def prepare(out_base_path: Path, norm_dir: Path, folders: List[Path],
            device=None) -> Dict[str, Dict[str, np.ndarray]]:
    """The prepared corpus: {output .hdf path: {hga_activity,
    lpc_coefficients, vad_labels, trial_ids}} for every recording of
    ``folders`` whose day has normalization data in ``norm_dir``."""
    device = resolve_device(device)
    normalization_recordings = norm_dir.glob("**/*.mat")
    syllable_repetitions = {p.parent.name: p for p in normalization_recordings}
    z_score_mapping = ZScoresFromSyllableRepetitions(syllable_repetitions,
                                                     device)

    corpus = {}
    accumulative_audio_sum = 0.0
    for folder in folders:
        for mat_file in folder.glob("**/*.mat"):
            if mat_file.parent.name not in z_score_mapping:
                logger.warning(
                    f"No normalization data for {mat_file.parent.name}. "
                    f"Skipping it!"
                )
                continue

            pipeline = FeatureExtractionPipeline(
                mat_filename=mat_file, wav_filename=mat_file.with_suffix(".wav"),
                min_trial_length=2.5, device=device,
            )
            ecog = pipeline.get_features()
            targ = pipeline.get_lpc_coefficients()
            nvad = pipeline.get_vad_labels()
            tids = pipeline.get_trial_ids()
            accumulative_audio_sum += pipeline.accumulative_audio_duration()

            norm_means, norm_stds = z_score_mapping[mat_file.parent.name]
            ecog = (ecog - norm_means) / norm_stds

            out_filename = out_base_path / mat_file.parent.name / \
                mat_file.with_suffix(".hdf").name
            corpus[out_filename.as_posix()] = dict(
                hga_activity=ecog, lpc_coefficients=targ, vad_labels=nvad,
                trial_ids=tids)

    logger.info(
        f"Finished. Total of {accumulative_audio_sum / 60 / 60:.02f}h of "
        f"speech data."
    )
    return corpus


def main(out_base_path: Path, norm_dir: Path, folders: List[Path],
         device=None) -> Dict[str, Dict[str, np.ndarray]]:
    """``prepare``, then each recording written as an HDF container."""
    corpus = prepare(out_base_path, norm_dir, folders, device)
    for out_filename, parameters in corpus.items():
        os.makedirs(Path(out_filename).parent, exist_ok=True)
        save_data_to_hdf(out_filename, parameters=parameters, overwrite=True)
    return corpus


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Prepare the speech-data corpus into features and labels "
                    "for training the neural network architectures.")
    parser.add_argument("out_dir", help="Directory for the feature/label HDF files.")
    parser.add_argument("norm_dir", help="Directory with the BCI2000 recordings used "
                                         "for normalization statistics.")
    parser.add_argument("folders", nargs="+",
                        help="Folders containing BCI2000 recording mat files.")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain versions of the kernels).")
    args = parser.parse_args()

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        datefmt="%d.%m.%y %H:%M:%S",
    )

    logger.info(f"prepare_corpus {args.out_dir} {args.norm_dir} {args.folders}")
    main(out_base_path=Path(args.out_dir), norm_dir=Path(args.norm_dir),
         folders=[Path(f) for f in args.folders], device=args.device)
