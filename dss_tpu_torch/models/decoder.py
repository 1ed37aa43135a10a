"""Bidirectional speech-synthesis decoder (counterpart of
dss_tpu/models/decoder.py): a 2-layer bidirectional LSTM (deployed: 100
hidden) and a Linear(2H -> 20) regressor producing LPCNet-style acoustic
features for a complete speech segment.

Inference on the card (gradients off, a width the kernel takes) runs the
whole forward as one launch of kernel D3 (ops/bilstm.py); every other call
(the CPU, training steps with autograd, wider models) runs ``nn.LSTM``
through ``run_lstm``."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import bilstm
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

    def takes_kernel(self, device) -> bool:
        """Whether ``forward`` on ``device`` runs kernel D3: a CUDA device,
        gradients off, dropout inactive and widths the kernel's plan
        takes."""
        return (torch.device(device).type == "cuda"
                and not torch.is_grad_enabled()
                and not (self.training and self.lstm.dropout > 0)
                and bilstm.kernel_plan(self.nb_electrodes,
                                       self.nb_hidden_units, self.nb_layer,
                                       self.nb_outputs)["supported"])

    def forward(self, x: torch.Tensor, state: Optional[LstmState] = None,
                mask: Optional[torch.Tensor] = None,
                lengths: Optional[Sequence[int]] = None,
                frames: Optional[int] = None):
        """x [B, T, E] -> (features [B, T, nb_outputs], new state); with a
        right-padding ``mask`` [B, T] or ``lengths``, valid positions and
        the state equal unpadded runs.  With ``frames`` (>= T) the features
        are [B, frames, nb_outputs], each row's frames past its length
        holding its last valid frame (``hold_last_frame``)."""
        if self.takes_kernel(x.device):
            if lengths is None:
                lengths = (mask.sum(dim=1).round().to(torch.int32)
                           if mask is not None else [x.shape[1]] * len(x))
            return bilstm.bilstm_decode(
                x, lengths, bilstm.decoder_weights(self.lstm, self.regressor),
                state, frames)
        if state is None:
            state = self.create_new_initial_state(x.shape[0])
        y, state = run_lstm(self.lstm, x, state, mask, lengths)
        pred = self.regressor(y)
        if frames is None:
            return pred, state
        if lengths is None:
            lengths = (mask.detach().cpu().sum(dim=1).round().long()
                       if mask is not None else [x.shape[1]] * len(x))
        return hold_last_frame(pred, lengths, frames), state


def hold_last_frame(pred: torch.Tensor, lengths: Sequence[int],
                    frames: Optional[int] = None) -> torch.Tensor:
    """pred [B, T, F] -> [B, frames (default T), F] with each row's frames
    past its length replaced by its last valid frame (the online unit's
    repeat-pad: a vocoder never consumes padding)."""
    T = pred.shape[1] if frames is None else frames
    last = torch.as_tensor(np.asarray(lengths) - 1, dtype=torch.long,
                           device=pred.device)
    idx = torch.minimum(torch.arange(T, device=pred.device)[None],
                        last[:, None])
    return pred.gather(1, idx[..., None].expand(-1, -1, pred.shape[2]))
