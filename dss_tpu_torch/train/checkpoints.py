"""Best-model checkpoints and training-state resume (counterpart of
dss_tpu/train/checkpoints.py).

``StoreBestModel`` keeps exactly one best weights file, updated when the
validation accuracy improves (nVAD) or the validation loss falls (decoder).
The file holds the model's state_dict under the torch layout names that
both packages read (``lstm.{weight,bias}_{ih,hh}_l{k}[_reverse]`` plus
``classifier.*`` or ``regressor.*``): a ``.pth`` through ``torch.save``,
any other name an ``.npz`` through ``np.savez``.

The vocoder's weights are an ``.npz`` of every parameter in the JAX
layouts (``save_vocoder_params``), which both packages load.

The training state is the port's own format (``train_state.pth``): the
model's (or the vocoder's parameter dict's) and the optimizer's state, the
learning-rate scheduler's when there is one, and a dict of extras, through
``torch.save``.  The JAX package pickles optax pytrees instead;
``convert.rmsprop_state`` and ``convert.adam_state`` carry such an
optimizer state over.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

Params = Dict[str, torch.Tensor]

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


def save_vocoder_params(filename: str, params: Dict[str, torch.Tensor]
                        ) -> None:
    """Write a vocoder parameter dict as an ``.npz``, key for key in the JAX
    layouts, mask included (as apps/train_vocoder.py's ``np.savez``), so
    that both packages load it."""
    np.savez(filename, **{k: v.detach().cpu().numpy()
                          for k, v in params.items()})


def save_train_state(filename: str, model: Union[nn.Module, Params],
                     optimizer: torch.optim.Optimizer,
                     extra: Optional[dict] = None,
                     scheduler=None) -> None:
    """Persist the full training state: the model (an ``nn.Module``, or a
    parameter dict such as the vocoder trainer's), the optimizer, the
    learning-rate scheduler when there is one, and the extras."""
    state = model.state_dict() if isinstance(model, nn.Module) else \
        {k: v.detach() for k, v in model.items()}
    blob = {"model": state, "optimizer": optimizer.state_dict(),
            "extra": extra or {}}
    if scheduler is not None:
        blob["scheduler"] = scheduler.state_dict()
    torch.save(blob, filename)


def load_train_state(filename: str, model: Union[nn.Module, Params],
                     optimizer: torch.optim.Optimizer, scheduler=None
                     ) -> dict:
    """Load a state written by ``save_train_state`` into ``model`` (a
    module, or a parameter dict updated in place, which must hold the same
    keys), ``optimizer`` (moved to the model's device) and ``scheduler``;
    returns the extras."""
    blob = torch.load(filename, map_location="cpu")
    if isinstance(model, nn.Module):
        model.load_state_dict(blob["model"])
    else:
        if sorted(blob["model"]) != sorted(model):
            raise ValueError(f"load_train_state: {filename} holds other "
                             f"parameters than the model")
        with torch.no_grad():
            for k, v in blob["model"].items():
                model[k].copy_(v)
    optimizer.load_state_dict(blob["optimizer"])
    if scheduler is not None and "scheduler" in blob:
        scheduler.load_state_dict(blob["scheduler"])
    return blob.get("extra", {})
