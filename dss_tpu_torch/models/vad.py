"""Unidirectional neural voice-activity detector (counterpart of
dss_tpu/models/vad.py): a 2-layer LSTM (deployed: 150 hidden, 64 inputs)
and a Linear(H -> 2) classifier, with an explicit carried (h, c)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .lstm import LstmState, run_lstm, zeros_state


class UnidirectionalVoiceActivityDetector(nn.Module):
    def __init__(self, nb_layer: int = 2, nb_hidden_units: int = 512,
                 nb_electrodes: int = 128, dropout: float = 0.0):
        super().__init__()
        self.nb_layer = nb_layer
        self.nb_hidden_units = nb_hidden_units
        self.nb_electrodes = nb_electrodes
        self.lstm = nn.LSTM(nb_electrodes, nb_hidden_units, nb_layer,
                            batch_first=True,
                            dropout=dropout if nb_layer > 1 else 0.0)
        self.classifier = nn.Linear(nb_hidden_units, 2)

    def create_new_initial_state(self, batch_size: int) -> LstmState:
        p = self.classifier.weight
        return zeros_state(self.lstm, batch_size, p.device, p.dtype)

    def forward(self, x: torch.Tensor, state: Optional[LstmState] = None,
                mask: Optional[torch.Tensor] = None,
                lengths: Optional[Sequence[int]] = None):
        """x [B, T, E] -> (logits [B, T, 2], new state)."""
        if state is None:
            state = self.create_new_initial_state(x.shape[0])
        y, state = run_lstm(self.lstm, x, state, mask, lengths)
        return self.classifier(y), state
