"""Stacked (bi)directional LSTMs on ``torch.nn.LSTM`` (counterpart of
dss_tpu/models/lstm.py).

``nn.LSTM`` has the reference's cell exactly: gate order i, f, g, o; two
bias vectors; layer k > 0 reads the direction-concatenated output of layer
k - 1; state layout [num_layers * num_directions, batch, hidden].

Masked right-padded batches run as packed sequences, so every valid
position and the final (h, c) equal an unpadded run in BOTH directions —
the backward direction never integrates the padding.  Outputs at padded
positions are zeros here (the JAX masked scan holds the last state there);
callers use valid positions only.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

LstmState = Tuple[torch.Tensor, torch.Tensor]  # (h, c): [L*D, B, H] each


def run_lstm(lstm: nn.LSTM, x: torch.Tensor, state: Optional[LstmState],
             mask: Optional[torch.Tensor] = None,
             lengths: Optional[Sequence[int]] = None
             ) -> Tuple[torch.Tensor, LstmState]:
    """x [B, T, in] (batch first) -> (y [B, T, D*H], (h, c)).

    ``lengths`` (B valid lengths, on the host) or a right-padding ``mask``
    [B, T] (1 = valid) selects the packed path; a batch whose every length
    is T runs the plain path.  Give ``lengths`` where the caller knows them:
    a mask on the card is read back to the host to find them."""
    if mask is None and lengths is None:
        return lstm(x, state)
    if lengths is None:
        lengths = mask.detach().to("cpu").sum(dim=1).round().long()
    lengths = torch.as_tensor(lengths, dtype=torch.int64).reshape(-1)
    T = x.shape[1]
    if bool((lengths == T).all()):
        return lstm(x, state)
    packed = pack_padded_sequence(x, lengths, batch_first=True,
                                  enforce_sorted=False)
    out, new_state = lstm(packed, state)
    y, _ = pad_packed_sequence(out, batch_first=True, total_length=T)
    return y, new_state


def zeros_state(lstm: nn.LSTM, batch_size: int, device=None,
                dtype=torch.float32) -> LstmState:
    D = 2 if lstm.bidirectional else 1
    shape = (lstm.num_layers * D, batch_size, lstm.hidden_size)
    return (torch.zeros(shape, device=device, dtype=dtype),
            torch.zeros(shape, device=device, dtype=dtype))


@torch.no_grad()
def seeded_init(module: nn.Module, seed: int) -> nn.Module:
    """torch's default LSTM/Linear initialization, U(-1/sqrt(H), 1/sqrt(H))
    for LSTM tensors and U(-1/sqrt(in), 1/sqrt(in)) for Linear ones, drawn
    from an explicit generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    for sub in module.modules():
        if isinstance(sub, nn.LSTM):
            bound = 1.0 / math.sqrt(sub.hidden_size)
        elif isinstance(sub, nn.Linear):
            bound = 1.0 / math.sqrt(sub.in_features)
        else:
            continue
        for p in sub.parameters(recurse=False):
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    return module
