"""Load LSTM checkpoints (counterpart of dss_tpu/models/torch_port.py).

Both the reference's ``.pth`` files and the JAX trainers' ``.npz`` twins
hold a torch-layout state_dict: ``lstm.{weight,bias}_{ih,hh}_l{k}[_reverse]``
plus ``classifier.*`` (VAD) or ``regressor.*`` (decoder) — the parameter
names of the port's modules, so the result loads with
``module.load_state_dict``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def expected_keys(num_layers: int, bidirectional: bool, head_name: str):
    suffixes = ["", "_reverse"] if bidirectional else [""]
    keys = [f"lstm.{kind}_{mat}_l{layer}{sfx}"
            for layer in range(num_layers) for sfx in suffixes
            for kind in ("weight", "bias") for mat in ("ih", "hh")]
    return keys + [f"{head_name}.weight", f"{head_name}.bias"]


def load_checkpoint(path: str, num_layers: int, bidirectional: bool,
                    head_name: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` or ``.npz`` checkpoint into a float32 state_dict
    holding exactly the keys of the model it is meant for."""
    if str(path).endswith(".npz"):
        with np.load(path) as f:
            raw = {k: torch.as_tensor(f[k]) for k in f.files}
    else:
        raw = torch.load(path, map_location="cpu")
    keys = expected_keys(num_layers, bidirectional, head_name)
    missing = [k for k in keys if k not in raw]
    if missing:
        raise KeyError(f"{path}: checkpoint lacks {missing}")
    return {k: torch.as_tensor(raw[k], dtype=torch.float32) for k in keys}
