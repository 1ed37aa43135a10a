"""Carry the JAX package's parameters over to the port.

Inputs are the JAX parameter pytrees with numpy leaves (``np.asarray`` of
each array), so this module needs no JAX:

* LSTM models: ``{"lstm": [[{w_ih, w_hh, b_ih, b_hh}, ...], ...],
  head_name: {weight, bias}}`` -> a torch state_dict for the port's
  ``UnidirectionalVoiceActivityDetector`` (head ``classifier``) or
  ``BidirectionalSpeechSynthesisModel`` (head ``regressor``).
* Vocoder: the flat dict of arrays -> a dict of tensors; the port keeps
  the JAX layouts ([in, out]) at its public functions.
* Optimizer: the JAX ``torch_rmsprop`` state ``{"sq": params pytree}`` ->
  the ``state`` entry of the port's ``torch.optim.RMSprop`` state_dict; the
  vocoder trainer's optax Adam state (``ScaleByAdamState``: ``mu``, ``nu``,
  ``count``) -> that of its ``torch.optim.Adam``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

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


def rmsprop_state(opt_state: Mapping, model: nn.Module, step: int = 0
                  ) -> Dict[int, Dict[str, torch.Tensor]]:
    """JAX ``torch_rmsprop`` state -> ``{i: {"step", "square_avg"}}`` for
    the i-th parameter of ``model.parameters()``, in ``lstm_state_dict``'s
    names and layouts: the ``state`` entry of an RMSprop state_dict, so

        sd = optimizer.state_dict(); sd["state"] = rmsprop_state(...)
        optimizer.load_state_dict(sd)

    resumes from it.  The JAX state counts no steps and torch's update does
    not read its count, so ``step`` is the caller's (for the record)."""
    head = "classifier" if hasattr(model, "classifier") else "regressor"
    sq = lstm_state_dict(opt_state["sq"], head)
    out = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        if tuple(sq[name].shape) != tuple(p.shape):
            raise ValueError(f"rmsprop_state: {name} is {tuple(p.shape)} in "
                             f"the model, {tuple(sq[name].shape)} in the "
                             f"state")
        # A copy: the optimizer updates its state in place, and the
        # tensor shares the caller's array.
        out[i] = {"step": torch.tensor(float(step)),
                  "square_avg": sq[name].to(p.device, copy=True)}
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


def adam_state(opt_state, params: Mapping[str, torch.Tensor]
               ) -> Tuple[Dict[int, Dict[str, torch.Tensor]], int]:
    """The JAX vocoder trainer's optax Adam state (the optimizer state
    pytree with numpy leaves; its ``ScaleByAdamState`` holds ``mu``, ``nu``
    and ``count``) -> (the ``state`` entry of a ``torch.optim.Adam``
    state_dict over the trainable parameters of ``params`` in their order
    (every key but ``gru_a_mask``, as ``VocoderTrainer.init`` builds it),
    the count of applied updates).  ``VocoderTrainer.load_optimizer_state``
    takes both.  The moments are copies: the optimizer updates its state in
    place."""
    stack = [opt_state]
    adam = None
    while stack:
        s = stack.pop()
        if hasattr(s, "mu") and hasattr(s, "nu"):
            adam = s
            break
        if isinstance(s, (tuple, list)):
            stack.extend(s)
    if adam is None:
        raise ValueError("adam_state: no ScaleByAdamState (mu, nu, count) in "
                         "the optimizer state")
    count = int(np.asarray(adam.count))
    out = {}
    for i, k in enumerate(k for k in params if k != "gru_a_mask"):
        p = params[k]
        moments = {}
        for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            m = np.asarray(tree[k], np.float32)
            if m.shape != tuple(p.shape):
                raise ValueError(f"adam_state: {k} is {tuple(p.shape)} in the "
                                 f"parameters, {m.shape} in the state")
            moments[name] = torch.tensor(m, device=p.device)  # a copy
        out[i] = {"step": torch.tensor(float(count)), **moments}
    return out, count
