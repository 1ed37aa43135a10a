"""Bidirectional speech-synthesis decoder (counterpart of
dss_tpu/models/decoder.py): a 2-layer bidirectional LSTM (deployed: 100
hidden) and a Linear(2H -> 20) regressor producing LPCNet-style acoustic
features for a complete speech segment."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .lstm import LstmState, run_lstm, zeros_state


class BidirectionalSpeechSynthesisModel(nn.Module):
    def __init__(self, nb_layer: int = 2, nb_hidden_units: int = 100,
                 nb_electrodes: int = 128, dropout: float = 0.0,
                 nb_outputs: int = 20):
        super().__init__()
        self.nb_layer = nb_layer
        self.nb_hidden_units = nb_hidden_units
        self.nb_electrodes = nb_electrodes
        self.nb_outputs = nb_outputs
        self.lstm = nn.LSTM(nb_electrodes, nb_hidden_units, nb_layer,
                            batch_first=True, bidirectional=True,
                            dropout=dropout if nb_layer > 1 else 0.0)
        self.regressor = nn.Linear(2 * nb_hidden_units, nb_outputs)

    def create_new_initial_state(self, batch_size: int) -> LstmState:
        p = self.regressor.weight
        return zeros_state(self.lstm, batch_size, p.device, p.dtype)

    def forward(self, x: torch.Tensor, state: Optional[LstmState] = None,
                mask: Optional[torch.Tensor] = None,
                lengths: Optional[Sequence[int]] = None):
        """x [B, T, E] -> (features [B, T, nb_outputs], new state); with a
        right-padding ``mask`` [B, T], valid positions equal unpadded
        runs."""
        if state is None:
            state = self.create_new_initial_state(x.shape[0])
        y, state = run_lstm(self.lstm, x, state, mask, lengths)
        return self.regressor(y), state


def hold_last_frame(pred: torch.Tensor, lengths: Sequence[int]
                    ) -> torch.Tensor:
    """pred [B, T, F] -> the same with each row's frames past its length
    replaced by its last valid frame (the online unit's repeat-pad: a
    vocoder never consumes padding)."""
    T = pred.shape[1]
    last = torch.as_tensor(np.asarray(lengths) - 1, dtype=torch.long,
                           device=pred.device)
    idx = torch.minimum(torch.arange(T, device=pred.device)[None],
                        last[:, None])
    return pred.gather(1, idx[..., None].expand_as(pred))
