"""nVAD trainer: truncated backpropagation through time (counterpart of
dss_tpu/train/trainer_vad.py).

RMSprop lr = 1e-4, cross-entropy, TBPTT with k1 = k2 = 50: each 50-frame
chunk of a trial runs its own forward, backward and optimizer step, and
the LSTM state (h, c) is carried, detached, into the next chunk.  A chunk
whose mask is all zero makes no update (no ``step()``, the optimizer's
``square_avg`` untouched); its forward still carries the state on.  B > 1
trials come from ``padded_batches``, padded at their ends; the mask is not
given to the LSTM, so the state runs through the padding as in the JAX
trainer, and the masked loss keeps the padding out of the gradients.

Batches arrive as numpy arrays; the mask is read on the host, which is
what decides the skipped chunks without asking the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.vad import UnidirectionalVoiceActivityDetector
from .optim import torch_rmsprop


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, count: Optional[float] = None
                         ) -> torch.Tensor:
    """Mean CE over valid frames. logits [..., 2], labels/mask [...].
    ``count`` replaces the number of valid frames as the denominator (a
    data-parallel shard divides by the global batch's)."""
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, labels.long()[..., None])[..., 0]
    if count is not None:
        return (ce * mask).sum() / count
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def to_device(a, device) -> torch.Tensor:
    """A host array as float32 on ``device``, copied without waiting for
    the work already queued there."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(device,
                                                         non_blocking=True)


class VadTrainer:
    """Owns the model (moved to ``device``, the card unless the caller asks
    for another) and its RMSprop optimizer."""

    def __init__(self, model: UnidirectionalVoiceActivityDetector,
                 learning_rate: float = 1e-4, chunk: int = 50, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.chunk = chunk
        self.optimizer = torch_rmsprop(self.model.parameters(), learning_rate)

    def tbptt_trial(self, x: np.ndarray, y: np.ndarray, mask: np.ndarray
                    ) -> torch.Tensor:
        """One trial (or padded batch of trials) of TBPTT. x [B, T, E],
        y [B, T], mask [B, T] on the host; T must be a multiple of the
        chunk length.  Returns the mean chunk loss (a device scalar)."""
        B, T, _ = x.shape
        if T % self.chunk:
            raise ValueError(f"trial length {T} is no multiple of the chunk "
                             f"length {self.chunk}")
        has_data = np.asarray(mask).reshape(B, -1, self.chunk).sum((0, 2)) > 0
        xd, yd, md = (to_device(a, self.device) for a in (x, y, mask))
        self.model.train()
        state = self.model.create_new_initial_state(B)
        losses = []
        for k, update in enumerate(has_data):
            part = slice(k * self.chunk, (k + 1) * self.chunk)
            with torch.set_grad_enabled(bool(update)):
                logits, state = self.model(xd[:, part], state)
                loss = masked_cross_entropy(logits, yd[:, part], md[:, part])
            if update:
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                self.optimizer.step()
            state = (state[0].detach(), state[1].detach())
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    @torch.no_grad()
    def evaluate(self, x: np.ndarray, y: np.ndarray, mask: np.ndarray
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        """Full-sequence eval: returns (loss, correct, total, probs)."""
        xd, yd, md = (to_device(a, self.device) for a in (x, y, mask))
        self.model.eval()
        logits, _ = self.model(xd)
        loss = masked_cross_entropy(logits, yd, md)
        pred = torch.argmax(logits, dim=-1)
        correct = ((pred == yd.long()) * md).sum()
        probs = torch.softmax(logits, dim=-1)[..., 1]
        return loss, correct, md.sum(), probs

    def pad_trial(self, x: np.ndarray, y: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pad one trial ([T, E], [T]) to a chunk multiple with a mask."""
        T = len(x)
        Tp = -(-T // self.chunk) * self.chunk
        xp = np.zeros((1, Tp, x.shape[1]), np.float32)
        yp = np.zeros((1, Tp), np.float32)
        m = np.zeros((1, Tp), np.float32)
        xp[0, :T] = x
        yp[0, :T] = y.reshape(T)
        m[0, :T] = 1.0
        return xp, yp, m
