"""Carry the JAX package's parameters over to the port.

Inputs are the JAX parameter pytrees with numpy leaves (``np.asarray`` of
each array), so this module needs no JAX:

* LSTM models: ``{"lstm": [[{w_ih, w_hh, b_ih, b_hh}, ...], ...],
  head_name: {weight, bias}}`` -> a torch state_dict for the port's
  ``UnidirectionalVoiceActivityDetector`` (head ``classifier``) or
  ``BidirectionalSpeechSynthesisModel`` (head ``regressor``).
* Vocoder: the flat dict of arrays -> a dict of tensors; the port keeps
  the JAX layouts ([in, out]) at its public functions.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .vocoder.lpcnet import _load_params


def lstm_state_dict(params: Mapping, head_name: str) -> Dict[str, torch.Tensor]:
    """JAX LSTM-model pytree -> torch state_dict (keys as in
    ``nn.LSTM`` / ``nn.Linear``)."""
    out: Dict[str, torch.Tensor] = {}
    lstm = params["lstm"]
    suffixes = ["", "_reverse"] if len(lstm[0]) == 2 else [""]
    for layer, dirs in enumerate(lstm):
        for d, p in enumerate(dirs):
            sfx = suffixes[d]
            for key, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                              ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                out[f"lstm.{name}_l{layer}{sfx}"] = torch.as_tensor(
                    np.asarray(p[key], np.float32))
    for key in ("weight", "bias"):
        out[f"{head_name}.{key}"] = torch.as_tensor(
            np.asarray(params[head_name][key], np.float32))
    return out


def vocoder_params(params: Mapping, device="cpu") -> Dict[str, torch.Tensor]:
    """JAX vocoder parameter dict -> the port's dict of tensors, key for
    key and in the JAX layouts.  The dict is flat, so a bunched
    checkpoint's extra keys (``emb_sig_l{j}``, ``emb_exc_l{j}``,
    ``fc_out{1,2}_{w,g}_b{j}``, ``fc_out_b_b{j}``, the optional inner
    biases ``fc_out{1,2}_b_b{j}``, ``bunch_exc_emb_b{j}``,
    ``bunch_pred_emb_b{j}``) and an imported checkpoint's ``emb_pitch``
    and ``fc_out{1,2}_b`` carry over like any other; ``LPCNetModel
    .from_params`` reads the bunch from them."""
    return _load_params(dict(params), device)
