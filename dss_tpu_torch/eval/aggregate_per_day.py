"""Aggregate per-day ECoG + audio for the acoustic-contamination analysis
(counterpart of eval/contamination/aggregate_per_day.py).

Each day's KeywordReading recordings are concatenated into one container
of speech-area ECoG (with the day-specific contaminated channel 46
excluded for 2022_10_05/06/10) plus the audio channel (index 128), and
energy-VAD speech timings are derived from the audio.  The output ``.mat``
layout is the JAX script's, so either package's analysis (or the original
MATLAB toolbox) reads it.  Everything here is host numpy, as in the JAX
script: there is no device work to move.

    python -m dss_tpu_torch.eval.aggregate_per_day --corpus-root DATA_DIR \
        --acc-path AGG_DIR --timing-path TIMING_DIR
"""

from __future__ import annotations

import argparse
import logging
import os
from collections import defaultdict
from pathlib import Path

import numpy as np
from scipy.io import loadmat, savemat

from ..ops.mel import EnergyBasedVad
from ..utils.channels import SelectElectrodesFromBothGrids, \
    SelectElectrodesOverSpeechAreas

logger = logging.getLogger("aggregate_per_day.py")

CONTAMINATED_DAYS = ("2022_10_05", "2022_10_06", "2022_10_10")
CONTAMINATED_CHANNELS = (46,)


def vad_timings(vad_labels: np.ndarray) -> np.ndarray:
    """(start, stop) second pairs of detected speech from VAD labels at a
    10 ms hop; a stream that ends voiced closes its last span at the end
    of the recording."""
    vad_labels = np.asarray(vad_labels).astype(bool)
    diff = (np.flatnonzero(vad_labels[:-1] != vad_labels[1:]) + 1).astype(
        np.float32)
    if vad_labels[0]:
        diff = np.concatenate([[0.0], diff])
    if len(diff) % 2 == 1:
        diff = np.concatenate([diff, [float(len(vad_labels))]])
    diff[1::2] -= 1
    diff *= 0.01
    timings = np.zeros((len(diff) // 2, 2), dtype=np.float32)
    timings[:, 0] = diff[0::2]
    timings[:, 1] = diff[1::2]
    return timings


def aggregate_data(speech_corpus_root: Path, agg_path: Path,
                   timing_path: Path) -> None:
    """Write ``{day}_KeywordReading_Overt.mat`` (fs, ecog, audio) into
    ``agg_path`` and ``{day}_KeywordReading_Overt_timings.mat`` (timings)
    into ``timing_path`` for every day under ``speech_corpus_root``."""
    feature_files = list(speech_corpus_root.rglob("KeywordReading_Overt_R*.mat"))
    groups_by_day = defaultdict(list)
    for feature_file in feature_files:
        groups_by_day[feature_file.parent.name].append(feature_file)

    selection_1 = SelectElectrodesFromBothGrids()
    selection_2 = SelectElectrodesOverSpeechAreas()
    for day, recordings in sorted(groups_by_day.items()):
        brain, audio, sampling_rates = [], [], set()
        for keyword_recording in recordings:
            mat = loadmat(keyword_recording.as_posix(), simplify_cells=True)
            fs = mat["parameters"]["SamplingRate"]["NumericValue"]
            gain = mat["parameters"]["SourceChGain"]["NumericValue"]

            ecog = selection_1(mat["signal"]) * selection_1(gain.reshape((1, -1)))
            if day in CONTAMINATED_DAYS:
                keep = np.array([c for c in selection_2.indices
                                 if c not in np.array(CONTAMINATED_CHANNELS) - 1])
                ecog = ecog[:, keep]
            else:
                ecog = selection_2(ecog)

            brain.append(ecog)
            audio.append(mat["signal"][:, 128] * gain[128])
            sampling_rates.add(fs)

        if len(sampling_rates) != 1:
            logger.warning("Found more than one sampling rate for day %s!", day)

        brain = np.concatenate(brain)
        audio = np.concatenate(audio)
        fs = sampling_rates.pop()

        vad_labels = EnergyBasedVad().from_wav(audio, sampling_rate=fs)
        timings = vad_timings(vad_labels)

        savemat(os.path.join(agg_path.as_posix(),
                             f"{day}_KeywordReading_Overt.mat"),
                dict(fs=fs, ecog=brain, audio=audio), format="5")
        savemat(os.path.join(timing_path.as_posix(),
                             f"{day}_KeywordReading_Overt_timings.mat"),
                dict(timings=timings), format="5")
        logger.info("Aggregated %s: %s samples, %d speech spans",
                    day, brain.shape, len(timings))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        "Prepare experiment recordings for the acoustic-contamination "
        "analysis (Roussel et al. pipeline, re-expressed in Python).")
    parser.add_argument("--corpus-root", required=True)
    parser.add_argument("--acc-path", required=True)
    parser.add_argument("--timing-path", required=True)
    args = parser.parse_args(argv)

    agg_path = Path(args.acc_path)
    timing_path = Path(args.timing_path)
    os.makedirs(agg_path.as_posix(), exist_ok=True)
    os.makedirs(timing_path.as_posix(), exist_ok=True)
    aggregate_data(Path(args.corpus_root), agg_path, timing_path)


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] [%(name)-30s] [%(levelname)8s]: %(message)s",
        datefmt="%d.%m.%y %H:%M:%S",
    )
    main()
