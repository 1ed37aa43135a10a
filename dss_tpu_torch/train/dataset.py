"""Trial-sequential dataset over prepared corpora (counterpart of
dss_tpu/train/dataset.py).

One item is one variable-length trial; trial boundaries are runs of
constant value in the sign-alternating ``trial_ids`` vector that corpus
preparation writes; the target is ``lpc_coefficients`` or ``vad_labels``.
``padded_batches`` groups trials by length into padded, masked batches.

A recording is a dict of those arrays.  ``SequentialSpeechTrials`` reads
its ``.hdf`` files with ``load_hdf`` and hands the dicts to
``SequentialSpeechTrials.from_recordings``, which builds the dataset; a
caller that holds the corpus in memory (corpus preparation's ``prepare``,
where h5py is not installed) calls ``from_recordings`` directly.  This is a
seam between reading and building, not a second kind of dataset.
"""

from __future__ import annotations

from fnmatch import fnmatch
from pathlib import Path
from typing import Callable, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from ..utils.hdf import load_hdf

Transform = Optional[Callable]
Recording = Mapping[str, np.ndarray]
Recordings = Optional[Mapping[str, Recording]]


def run_boundaries(seq: np.ndarray) -> List[Tuple[int, int]]:
    """(start, stop) spans of maximal constant runs in ``seq``."""
    seq = np.asarray(seq)
    change = (np.flatnonzero(seq[:-1] != seq[1:]) + 1).tolist()
    edges = [0] + change + [len(seq)]
    return list(zip(edges[:-1], edges[1:]))


def squeeze_trial_ids(trial_ids: np.ndarray) -> List[int]:
    """Collapse runs to one (absolute) stimulus id per trial."""
    out = [int(trial_ids[0])]
    last = trial_ids[0]
    for v in trial_ids[1:]:
        if v != last:
            out.append(abs(int(v)))
            last = v
    return out


def corpus_files(root, pattern: str = "*.hdf",
                 recordings: Recordings = None) -> List[Path]:
    """The corpus's files whose name matches ``pattern``: found under
    ``root``, or the keys of ``recordings`` when the corpus is in memory."""
    if recordings is None:
        return list(Path(root).rglob(pattern))
    return [Path(k) for k in recordings if fnmatch(Path(k).name, pattern)]


class SequentialSpeechTrials:
    """Each item is one trial: (hga [T, ch], target [T, .])."""

    def __init__(self, feature_files: List[str], transform: Transform = None,
                 target_transform: Transform = None,
                 target_specifier: str = "lpc_coefficients"):
        files = [str(f) for f in feature_files]
        self._build({f: load_hdf(f) for f in files}, transform,
                    target_transform, target_specifier)

    @classmethod
    def from_recordings(cls, recordings: Mapping[str, Recording],
                        transform: Transform = None,
                        target_transform: Transform = None,
                        target_specifier: str = "lpc_coefficients"
                        ) -> "SequentialSpeechTrials":
        """The dataset of in-memory recordings, keyed by file name."""
        self = cls.__new__(cls)
        self._build(recordings, transform, target_transform,
                    target_specifier)
        return self

    def _build(self, recordings: Mapping[str, Recording], transform,
               target_transform, target_specifier) -> None:
        self.feature_files = [str(f) for f in recordings]
        self.transform = transform
        self.target_transform = target_transform
        self.target_specifier = target_specifier

        self._trials: List[Tuple[np.ndarray, np.ndarray]] = []
        self.trial_labels: List[int] = []
        self.trial_filename: List[str] = []
        self.frame_counter = 0
        for fname, data in recordings.items():
            trial_ids = data["trial_ids"]
            self.frame_counter += len(trial_ids)
            labels = squeeze_trial_ids(trial_ids)
            self.trial_labels.extend(labels)
            self.trial_filename.extend([str(fname)] * len(labels))
            hga = data["hga_activity"]
            target = data[target_specifier]
            for start, stop in run_boundaries(trial_ids):
                self._trials.append((hga[start:stop], target[start:stop]))

    def __len__(self) -> int:
        return len(self._trials)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        hga, target = self._trials[index]
        if self.transform:
            hga = self.transform(hga)
        if self.target_transform:
            target = self.target_transform(target)
        return hga, target

    def __repr__(self) -> str:
        days = sorted({Path(f).parent.name for f in self.feature_files})
        hours = (self.frame_counter * 0.01) / 3600
        return (
            f"SequentialSpeechTrials: {len(self)} trials with "
            f"{self.frame_counter} frames (total: {hours:.02f}h). "
            f"Days covered: {', '.join(days)}"
        )


def datasets(files_lists: List[List[str]], recordings: Recordings = None,
             **kw) -> List[SequentialSpeechTrials]:
    """One ``SequentialSpeechTrials`` per list of files, each file read from
    disk or, when ``recordings`` is given, taken from it."""
    corpus = recordings if recordings is not None else \
        {f: load_hdf(f) for files in files_lists for f in files}
    return [SequentialSpeechTrials.from_recordings(
        {f: corpus[f] for f in files}, **kw) for files in files_lists]


def padded_batches(
    dataset,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    length_multiple: int = 50,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield length-bucketed (x [B, T, C], y [B, T, .], mask [B, T]) numpy
    batches: trials sorted by length, grouped, each batch padded to the
    next multiple of ``length_multiple``; with ``rng`` the batches (not the
    items) are shuffled.  The mask stays on the host, so a trainer reads
    the lengths from it without asking the card."""
    order = np.argsort([len(dataset[i][0]) for i in range(len(dataset))],
                       kind="stable")
    batches = [order[i:i + batch_size] for i in range(0, len(order), batch_size)]
    if rng is not None:
        rng.shuffle(batches)

    for batch_idx in batches:
        items = [dataset[i] for i in batch_idx]
        max_len = max(len(x) for x, _ in items)
        T = -(-max_len // length_multiple) * length_multiple
        B = len(items)
        x0, y0 = items[0]
        x = np.zeros((B, T) + x0.shape[1:], np.float32)
        y_shape = (B, T) + y0.shape[1:] if y0.ndim > 1 else (B, T)
        y = np.zeros(y_shape, np.float32)
        mask = np.zeros((B, T), np.float32)
        for b, (xb, yb) in enumerate(items):
            x[b, :len(xb)] = xb
            y[b, :len(yb)] = yb
            mask[b, :len(xb)] = 1.0
        yield x, y, mask
