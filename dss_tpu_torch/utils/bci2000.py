"""BCI2000 ``.mat`` recording wrapper and experiment trial parsers (the
port's own copy of dss_tpu/utils/bci2000.py; numpy and scipy only).

A recording exports a ``signal`` [T, 128] array, per-channel ``SourceChGain``,
a ``states.StimulusCode`` vector of per-sample stimulus identifiers, and the
stimulus labels.  Trials are derived from runs of constant stimulus code; the
SyllableRepetition task additionally relabels the silent "patient speaks"
phase that follows each auditory presentation phase.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
from scipy.io import loadmat

TrialIndices = Tuple[str, int, int]


def code_change_points(stimulus_code: np.ndarray) -> np.ndarray:
    """Sample indices at which the stimulus code changes value."""
    stimulus_code = np.asarray(stimulus_code)
    return np.flatnonzero(stimulus_code[:-1] != stimulus_code[1:]) + 1


class Experiment(ABC):
    """Extract labeled trial / stimulus spans from a stimulus-code vector."""

    def __init__(
        self,
        stimulus_code: np.ndarray,
        stimuli: Union[Dict[int, str], List[str]],
    ):
        self.stimulus_code = np.asarray(stimulus_code)
        if isinstance(stimuli, list):
            # Position in the list determines the code; 0 is reserved for
            # "no stimulus".
            stimuli = {index + 1: item for index, item in enumerate(stimuli)}
        self.stimuli: Dict[int, str] = stimuli

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}(len: {len(self.stimulus_code)} "
            f"samples, with {len(self.stimuli)} stimuli across "
            f"{len(self.get_trial_indices())} trials)"
        )

    def _trial_boundaries(self) -> List[Tuple[int, int]]:
        """Consecutive (start, stop) spans between code change points.

        The span before the first change and after the last change are not
        included — the same contract as the reference's difference method
        (local/common.py:692-694).
        """
        change = code_change_points(self.stimulus_code)
        return list(zip(change[:-1], change[1:]))

    @staticmethod
    def trial_indices_to_lab(
        filename: str, trial_indices: List[TrialIndices], fs: int
    ) -> None:
        with open(filename, "w") as f:
            for label, start, stop in trial_indices:
                f.write(f"{start / fs:.03f}\t{stop / fs:.03f}\t{label}\n")

    @abstractmethod
    def get_trial_indices(self) -> List[TrialIndices]:
        ...

    @abstractmethod
    def get_stimuli_indices(self) -> List[TrialIndices]:
        ...

    def _scan_nonzero_spans(self) -> List[TrialIndices]:
        """Spans that start when the code becomes non-zero and end when it
        returns to zero, labeled by the stimulus at span start."""
        code = self.stimulus_code
        result: List[TrialIndices] = []
        start: Optional[int] = None
        label: Optional[str] = None
        for i in range(len(code)):
            if code[i] != 0 and start is None:
                start = i
                label = self.stimuli[int(code[i])]
            elif code[i] == 0 and start is not None:
                result.append((label, start, i))
                start = None
                label = None
        return result

    def get_webfm_baseline_windows(
        self, fs: int, length: float = 0.8
    ) -> List[TrialIndices]:
        """Pre-stimulus windows used as high-gamma baselines."""
        trials = self.get_stimuli_indices()
        return [("BL", int(start - length * fs), start) for _, start, _ in trials]

    def get_experiment_run_indices(self) -> TrialIndices:
        """Span of the whole experiment run (first code change to last trial
        end), excluding leading/trailing idle recording."""
        boundaries = self._trial_boundaries()
        start = boundaries[0][0]
        stop = self.get_trial_indices()[-1][2]
        return "Experiment run", start, stop

    @staticmethod
    def get_stimuli_values() -> Optional[list]:
        return None


class SyllableRepetition(Experiment):
    """Auditory presentation followed by the patient repeating the syllable.

    Odd spans (code != 0) are the presentation phase; the following span of
    code 0 is the speaking phase.  Trials are the *speaking* spans, labeled
    with the preceding presentation's stimulus (reference
    local/common.py:744-809).
    """

    def get_trial_indices(self) -> List[TrialIndices]:
        spans = self._trial_boundaries()
        if not spans:
            return []

        # The final speaking span has no trailing change point; append it
        # using the canonical trial length (duration of the first speaking
        # span), clamped to the recording length.
        trial_length = min(spans[1][1] - spans[1][0], len(self.stimulus_code))
        spans.append((spans[-1][1], spans[-1][1] + trial_length))

        presentation = spans[::2]
        speaking = spans[1::2]

        trials: List[TrialIndices] = []
        for (p_start, _), (s_start, s_stop) in zip(presentation, speaking):
            code = int(self.stimulus_code[p_start])
            if code != 0:
                trials.append((self.stimuli[code], int(s_start), int(s_stop)))
        return trials

    def get_stimuli_indices(self) -> List[TrialIndices]:
        return self._scan_nonzero_spans()


class KeywordReading(Experiment):
    """Keywords shown on screen; trial and stimulus spans coincide
    (reference local/common.py:812-840)."""

    def get_trial_indices(self) -> List[TrialIndices]:
        return self.get_stimuli_indices()

    def get_stimuli_indices(self) -> List[TrialIndices]:
        return self._scan_nonzero_spans()


class ExperimentMapping(dict):
    """Map experiment-name substrings in filenames to Experiment classes."""

    def __init__(self):
        super().__init__()
        self.update(
            {
                "SyllableRepetition": SyllableRepetition,
                "KeywordReading": KeywordReading,
                "KeywordSynthesis": KeywordReading,
            }
        )

    @staticmethod
    def get_experiment_class(mat_filename: str):
        filename = os.path.basename(mat_filename)
        for key, cls in ExperimentMapping().items():
            if key in filename:
                return cls
        return None

    @staticmethod
    def extract_stimuli_values(mat: dict) -> List[str]:
        stimuli = mat["parameters"]["Stimuli"]["Value"]
        stimuli = np.asarray(stimuli)
        if stimuli.ndim == 0:
            # simplify_cells collapses a single stimulus to a bare string.
            return [stimuli.item()]
        if stimuli.ndim == 1:
            return [stimuli[0]]
        return stimuli[0].tolist()


class BCI2000MatFile:
    """Convenience accessors over a BCI2000-exported ``.mat`` recording."""

    def __init__(self, mat_filename: str):
        self.mat_filename = mat_filename
        self.mat = loadmat(self.mat_filename, simplify_cells=True)
        self.fs = self.mat["parameters"]["SamplingRate"]["NumericValue"]

    def bad_channels(self) -> Optional[List[int]]:
        """Bad channels recorded as 'chanNN' strings; None when absent."""
        if "bad_channels" not in self.mat.keys():
            return None
        bad_channels = self.mat["bad_channels"]
        if isinstance(bad_channels, np.ndarray):
            bad_channels = bad_channels.tolist()
        if not isinstance(bad_channels, list):
            bad_channels = [bad_channels]
        return [int(str(bc)[4:]) for bc in bad_channels]

    def contaminated_channels(self) -> Optional[List[int]]:
        if "contaminated_electrodes" not in self.mat.keys():
            return None
        contaminated = self.mat["contaminated_electrodes"]
        if isinstance(contaminated, (int, np.integer)):
            return [int(contaminated)]
        return np.asarray(contaminated).tolist()

    def _experiment(self) -> Experiment:
        stimuli = ExperimentMapping.extract_stimuli_values(self.mat)
        stimulus_code = self.mat["states"]["StimulusCode"]
        experiment_class = ExperimentMapping.get_experiment_class(
            mat_filename=self.mat_filename
        )
        if experiment_class is None:
            raise ValueError(
                f"No experiment parser matches filename {self.mat_filename}"
            )
        return experiment_class(stimulus_code, stimuli)

    def trial_indices(
        self, min_trial_length: Optional[float] = None
    ) -> List[TrialIndices]:
        trial_indices = self._experiment().get_trial_indices()
        if min_trial_length is not None:
            nb_min_samples = min_trial_length * self.fs
            trial_indices = [
                (label, start, max(stop, start + nb_min_samples))
                for label, start, stop in trial_indices
            ]
        return trial_indices

    def stimuli_indices(self) -> List[TrialIndices]:
        return self._experiment().get_stimuli_indices()

    def signals(self) -> np.ndarray:
        """Raw signal scaled to physical units by per-channel source gain."""
        return self.mat["signal"] * self.mat["parameters"]["SourceChGain"]["NumericValue"]

    def ordered_stimulus_codes(self) -> List[int]:
        codes = sorted(np.unique(self.mat["states"]["StimulusCode"]).tolist())
        return codes[1:]
