"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is requested (or defaulted) and no card
    is present — there is no silent CPU fallback.

    On CUDA this also turns TF32 off for matmuls and cuDNN (the LSTMs and
    any convolution): the port computes in full float32, as the reference
    does, and its tolerances against the plain versions assume so.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dss_tpu_torch: no CUDA device found; pass device='cpu' to "
                "run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


_constants = {}


def device_constant(key, device, dtype, make) -> torch.Tensor:
    """A constant tensor ``make()`` (numpy) on ``device``, built once per
    (key, device, dtype).  Copying a host array to the card on every call
    would synchronize the host with the stream and stall work queued
    behind it."""
    k = (key, str(device), dtype)
    t = _constants.get(k)
    if t is None:
        t = torch.as_tensor(make(), dtype=dtype, device=device)
        _constants[k] = t
    return t
