"""The optimizer of both trainers (counterpart of dss_tpu/train/optim.py).

The reference trains both models with ``torch.optim.RMSprop(lr=1e-4)``;
the JAX package's ``torch_rmsprop`` exists only to reproduce that formula
(eps outside the square root).  Here the library optimizer is itself the
implementation:

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
