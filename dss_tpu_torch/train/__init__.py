"""Training of the nVAD and the decoder (counterpart of dss_tpu/train)."""

from .checkpoints import StoreBestModel, load_train_state, save_train_state
from .dataset import SequentialSpeechTrials, padded_batches
from .optim import torch_rmsprop
from .synth_queue import AsynchronousSynthesisQueue

__all__ = [
    "SequentialSpeechTrials",
    "padded_batches",
    "StoreBestModel",
    "save_train_state",
    "load_train_state",
    "torch_rmsprop",
    "AsynchronousSynthesisQueue",
]
