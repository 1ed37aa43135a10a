"""The trainers' optimizers (counterpart of dss_tpu/train/optim.py, and of
the ``optax.adam`` in dss_tpu/train/trainer_vocoder.py:111-120).

The reference trains the nVAD and the decoder with
``torch.optim.RMSprop(lr=1e-4)``; the JAX package's ``torch_rmsprop`` exists
only to reproduce that formula (eps outside the square root).  Here the
library optimizer is itself the implementation:

    sq = alpha * sq + (1 - alpha) * g^2 ;  p -= lr * g / (sqrt(sq) + eps)
"""

from __future__ import annotations

from typing import Iterable

import torch


def torch_rmsprop(params: Iterable[torch.nn.Parameter], learning_rate: float,
                  alpha: float = 0.99, eps: float = 1e-8
                  ) -> torch.optim.RMSprop:
    """``torch.optim.RMSprop`` with no momentum, not centered."""
    return torch.optim.RMSprop(params, lr=learning_rate, alpha=alpha,
                               eps=eps, momentum=0.0, centered=False)


def torch_adam(params: Iterable[torch.Tensor], learning_rate: float,
               lr_decay: float = 0.0):
    """The vocoder trainer's optimizer (``optax.adam`` in the JAX package):
    ``torch.optim.Adam`` with betas 0.9 / 0.999 and eps 1e-8 outside the
    square root, as optax's.  With ``lr_decay`` > 0 the rate is
    ``learning_rate / (1 + lr_decay * t)`` at the t-th applied update (t from
    0), the xiph LPCNet schedule, through a ``LambdaLR`` that the caller
    steps once after each ``optimizer.step()``.  Returns (optimizer,
    scheduler or None)."""
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    if lr_decay <= 0.0:
        return opt, None
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 1.0 / (1.0 + lr_decay * step))
    return opt, sched
