"""Streaming VAD label smoothing and speech-segment assembly on the host
(a numpy copy of dss_tpu/ops/ringbuffer.py's two classes).

* ``VoiceActivityDetectionSmoothing``: a ring of ``2*context + 1`` frames;
  the output label is the majority vote (ratio >= threshold) over the
  ring, and the output frame is read ``2*context`` positions behind the
  write, so labels align with a symmetric window.
* ``SpeechSegmentHistory``: once ``context`` non-speech frames follow a
  run of speech, the segment spanning ``2*context + n_speech`` frames is
  emitted.
"""

from __future__ import annotations

from math import floor
from typing import List, Tuple

import numpy as np


class VoiceActivityDetectionSmoothing:
    """Majority-vote smoothing with aligned data delay."""

    def __init__(self, nb_features: int, context_frames: int,
                 proportion_threshold: float = 0.6, shift: float = 0.01):
        self.frameshift = shift
        self.nb_features = nb_features
        self.vad_context_frames = context_frames
        self.vad_proportion_threshold = proportion_threshold
        self.buffer_size = 2 * context_frames + 1
        self.buffer = np.zeros((self.buffer_size, nb_features), dtype=np.float32)
        self.labels = np.zeros(self.buffer_size, dtype=bool)
        self.write_pointer = 2 * context_frames
        self.read_pointer = 0

    def insert(self, data: np.ndarray, speech_labels: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-packet update, equal to inserting one frame at a time: the
        ring unrolled into write order turns the vote into prefix-sum
        differences over a sliding window."""
        n = len(speech_labels)
        w = self.buffer_size
        order = (self.write_pointer + np.arange(w)) % w

        timeline_labels = np.concatenate(
            [self.labels[order], np.asarray(speech_labels, dtype=bool)])
        timeline_data = np.concatenate(
            [self.buffer[order], np.asarray(data, dtype=np.float32)], axis=0)

        prefix = np.concatenate([[0], np.cumsum(timeline_labels)])
        counts = prefix[w + 1 + np.arange(n)] - prefix[1 + np.arange(n)]
        out_labels = counts / w >= self.vad_proportion_threshold
        out_data = timeline_data[1:n + 1].copy()

        self.write_pointer = (self.write_pointer + n) % w
        self.read_pointer = (self.read_pointer + n) % w
        restore = (self.write_pointer + np.arange(w)) % w
        self.labels[restore] = timeline_labels[n:n + w]
        self.buffer[restore] = timeline_data[n:n + w]
        return out_data, out_labels

    def __repr__(self) -> str:
        delay_s = floor(self.buffer_size / 2) * self.frameshift
        return (
            f"VoiceActivityDetectionSmoothing(window={self.buffer_size} frames"
            f" / {self.buffer_size * self.frameshift:.02f} s, label delay"
            f" ~{delay_s} s, majority>={self.vad_proportion_threshold:.02f})"
        )


class SpeechSegmentHistory:
    """Assemble completed speech segments from a smoothed label stream."""

    def __init__(self, nb_features: int, buffer_size: int, context: int = 0):
        self.buffer = np.zeros((buffer_size, nb_features), dtype=np.float32)
        self.write_pointer = 0
        self.context = context
        self.speech_frame_counter = 0
        self.future_frame_counter = 0

    def insert(self, data: np.ndarray, speech_labels: np.ndarray
               ) -> List[np.ndarray]:
        size = len(self.buffer)
        result: List[np.ndarray] = []
        for i in range(len(speech_labels)):
            self.buffer[self.write_pointer, :] = data[i]
            self.write_pointer = (self.write_pointer + 1) % size

            if speech_labels[i]:
                self.speech_frame_counter += 1
                # The trailing-context countdown is NOT reset here: the
                # reference counts every non-speech frame since the
                # segment started, not consecutive ones.
                continue

            if self.speech_frame_counter > 0:
                self.future_frame_counter += 1
                if self.future_frame_counter >= self.context:
                    stop = self.write_pointer if self.context > 0 \
                        else (self.write_pointer - 1) % size
                    length = 2 * self.context + self.speech_frame_counter
                    start = (stop - length) % size
                    idx = (start + np.arange(length)) % size
                    result.append(self.buffer[idx].copy())
                    self.speech_frame_counter = 0
                    self.future_frame_counter = 0
        return result
