"""Training of the nVAD, the decoder and the neural vocoder (counterpart of
dss_tpu/train)."""

from .checkpoints import StoreBestModel, load_train_state, \
    save_train_state, save_vocoder_params
from .dataset import SequentialSpeechTrials, padded_batches
from .optim import torch_adam, torch_rmsprop
from .synth_queue import AsynchronousSynthesisQueue
from .trainer_vocoder import VocoderBatch, VocoderTrainer, prepare_utterance

__all__ = [
    "SequentialSpeechTrials",
    "padded_batches",
    "StoreBestModel",
    "save_train_state",
    "load_train_state",
    "save_vocoder_params",
    "torch_rmsprop",
    "torch_adam",
    "VocoderTrainer",
    "VocoderBatch",
    "prepare_utterance",
    "AsynchronousSynthesisQueue",
]
