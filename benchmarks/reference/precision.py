"""The reference computes in float32 without TF32: a context that turns
TF32 off for cuBLAS and cuDNN and puts back what the process had (the
program under test runs with its own settings)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
