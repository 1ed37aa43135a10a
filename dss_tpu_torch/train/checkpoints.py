"""Best-model checkpoints and training-state resume (counterpart of
dss_tpu/train/checkpoints.py).

``StoreBestModel`` keeps exactly one best weights file, updated when the
validation accuracy improves (nVAD) or the validation loss falls (decoder).
The file holds the model's state_dict under the torch layout names that
both packages read (``lstm.{weight,bias}_{ih,hh}_l{k}[_reverse]`` plus
``classifier.*`` or ``regressor.*``): a ``.pth`` through ``torch.save``,
any other name an ``.npz`` through ``np.savez``.

The training state is the port's own format: the model's and the
optimizer's ``state_dict`` and a dict of extras, through ``torch.save``.
The JAX package pickles optax pytrees instead; ``convert.rmsprop_state``
carries such an optimizer state over.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch
from torch import nn

logger = logging.getLogger("dss_tpu_torch.train.checkpoints")


def save_params(filename: str, model: nn.Module) -> None:
    """Write ``model``'s parameters as a ``.pth`` or an ``.npz``."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if str(filename).endswith(".pth"):
        torch.save(state, filename)
    else:
        np.savez(filename, **{k: v.numpy() for k, v in state.items()})


class StoreBestModel:
    """Store the best parameters (by val accuracy OR val loss) to one file.
    ``head_name`` is the head the file is meant for (``classifier`` or
    ``regressor``); the model's own names are written."""

    def __init__(self, filename: str, head_name: str = "classifier",
                 info: Optional[dict] = None):
        self.current_best_validation_acc = -np.inf
        self.current_best_validation_loss = np.inf
        self.filename = str(filename)
        self.head_name = head_name
        self.optional_info = info

    def update(self, model: nn.Module, validation_acc: Optional[float] = None,
               validation_loss: Optional[float] = None,
               info: Optional[dict] = None) -> bool:
        if validation_acc is not None and validation_loss is not None:
            raise ValueError("Class can only be used for either accuracy or loss.")
        if not hasattr(model, self.head_name):
            raise ValueError(f"the model has no {self.head_name!r} head")

        updated = False
        if validation_acc is not None and \
                validation_acc > self.current_best_validation_acc:
            save_params(self.filename, model)
            self.current_best_validation_acc = validation_acc
            logger.info(f"Updated best model weights for a score of {validation_acc}.")
            self.optional_info = info
            updated = True

        if validation_loss is not None and \
                validation_loss < self.current_best_validation_loss:
            save_params(self.filename, model)
            self.current_best_validation_loss = validation_loss
            logger.info(f"Updated best model weights for a score of {validation_loss}.")
            updated = True
        return updated


def save_train_state(filename: str, model: nn.Module,
                     optimizer: torch.optim.Optimizer,
                     extra: Optional[dict] = None) -> None:
    """Persist the full training state (model, optimizer, extras)."""
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "extra": extra or {}}, filename)


def load_train_state(filename: str, model: nn.Module,
                     optimizer: torch.optim.Optimizer) -> dict:
    """Load a state written by ``save_train_state`` into ``model`` and
    ``optimizer`` (moved to the model's device); returns the extras."""
    blob = torch.load(filename, map_location="cpu")
    model.load_state_dict(blob["model"])
    optimizer.load_state_dict(blob["optimizer"])
    return blob.get("extra", {})
