"""Decoder trainer: full-sequence BPTT on complete trials (counterpart of
dss_tpu/train/trainer_decoder.py).

RMSprop lr = 1e-4, masked MSE, one optimizer update per trial or padded
batch: full backpropagation through the masked bidirectional LSTM.  The
LSTM runs packed (``models/lstm.py::run_lstm``), so its backward direction
never integrates the padding.  Its lengths are read from the mask on the
host: ``pad_trial`` and ``padded_batches`` make host masks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.decoder import BidirectionalSpeechSynthesisModel
from .optim import torch_rmsprop
from .trainer_vad import to_device


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
    """Mean squared error over valid elements. pred/target [B, T, F],
    mask [B, T]."""
    se = (pred - target).square() * mask[..., None]
    return se.sum() / torch.clamp(mask.sum() * pred.shape[-1], min=1.0)


class DecoderTrainer:
    """Owns the model (moved to ``device``, the card unless the caller asks
    for another) and its RMSprop optimizer."""

    def __init__(self, model: BidirectionalSpeechSynthesisModel,
                 learning_rate: float = 1e-4, length_multiple: int = 50,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.length_multiple = length_multiple
        self.optimizer = torch_rmsprop(self.model.parameters(), learning_rate)

    def _run(self, x, mask):
        """(prediction [B, T, F], the mask on the device).  The packed LSTM
        takes its lengths from the mask on the host: a host mask, as
        ``pad_trial`` and ``padded_batches`` make it, costs no wait for the
        card (a mask on the card is read back)."""
        mask = torch.as_tensor(mask).cpu().numpy()
        lengths = np.rint(mask.sum(axis=1)).astype(np.int64)
        pred, _ = self.model(to_device(x, self.device), lengths=lengths)
        return pred, to_device(mask, self.device)

    def train_step(self, x: np.ndarray, y: np.ndarray, mask) -> torch.Tensor:
        """One full-BPTT update. x [B, T, E], y [B, T, F], mask [B, T].
        Returns the loss before the update (a device scalar)."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        pred, md = self._run(x, mask)
        loss = masked_mse(pred, to_device(y, self.device), md)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def evaluate(self, x: np.ndarray, y: np.ndarray, mask) -> torch.Tensor:
        self.model.eval()
        pred, md = self._run(x, mask)
        return masked_mse(pred, to_device(y, self.device), md)

    @torch.no_grad()
    def predict(self, x: np.ndarray, mask: Optional[np.ndarray] = None
                ) -> torch.Tensor:
        """Inference on [B, T, E] -> [B, T, F] from a zero state, as the
        online unit runs each segment; with a mask, only valid positions
        are meaningful."""
        self.model.eval()
        if mask is None:
            return self.model(to_device(x, self.device))[0]
        return self._run(x, mask)[0]

    def pad_trial(self, x: np.ndarray, y: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        T = len(x)
        Tp = -(-T // self.length_multiple) * self.length_multiple
        xp = np.zeros((1, Tp, x.shape[1]), np.float32)
        yp = np.zeros((1, Tp, y.shape[1]), np.float32)
        m = np.zeros((1, Tp), np.float32)
        xp[0, :T] = x
        yp[0, :T] = y
        m[0, :T] = 1.0
        return xp, yp, m
