"""Sharding rules and sharded training and inference steps (counterpart of
dss_tpu/parallel/shard.py) on ``torch.distributed``.

Layout, as in the JAX package:
* batch / stream axis -> mesh "data": each rank holds a contiguous block
  of rows (``shard_batch``) and the vocoder state of its streams
  (``batched_vocoder_sharding``);
* LSTM gate matrices [4H, in] / [4H, H] and gate biases [4H] -> mesh
  "model" on the 4H axis (Megatron-style tensor parallelism: each rank
  computes its gate rows, and an all-gather rebuilds the 4H gates before
  the cell update at every step; ``shard_lstm_params``);
* everything else replicated.

Where GSPMD inserts the collectives in JAX, each is written out here: the
training steps all-reduce the gradients over "data" between the backward
and the update, and the gate-parallel LSTM runs Megatron's f / g pair over
"model".  A rank runs its own rows; no rank holds the global batch on its
device.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..models.decoder import BidirectionalSpeechSynthesisModel, \
    hold_last_frame
from ..models.lstm import seeded_init
from ..models.vad import UnidirectionalVoiceActivityDetector
from ..train.trainer_decoder import DecoderTrainer, masked_mse
from ..train.trainer_vad import VadTrainer, masked_cross_entropy, to_device
from ..vocoder.lpc import FRAME_SIZE
from ..vocoder.net import NetVocoderState, net_synthesize_frames
from .mesh import axis, mesh_device


# -- the model axis: gate blocks ----------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward of an input every rank of the
    model group multiplies by its own gate rows; the backward sums the
    ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherGates(torch.autograd.Function):
    """Megatron's g: each rank's gate rows [.., 4H/p] -> the 4H gates, by
    an all-gather; the loss is replicated over the model group, so the
    backward of a rank's rows is its own slice of the gradient."""

    @staticmethod
    def forward(ctx, local, group, parts, index):
        ctx.index, ctx.width = index, local.shape[-1]
        out = [torch.empty_like(local) for _ in range(parts)]
        dist.all_gather(out, local.contiguous(), group=group)
        return torch.cat(out, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[..., lo:lo + ctx.width], None, None, None


def _is_gate_block(shape, hidden4: int) -> bool:
    """The JAX rule: a tensor whose leading dimension is 4H is split over
    "model" on that axis."""
    return len(shape) >= 1 and shape[0] == hidden4


def lstm_block_state_dict(state: Mapping, hidden_size: int, index: int,
                          parts: int) -> dict:
    """A model's state_dict -> rank ``index`` of ``parts``'s: the rows
    ``index * 4H / parts ..`` of every gate tensor, everything else whole.
    ``state`` is the port's state_dict or the JAX package's parameter
    pytree (numpy leaves, carried over by ``convert.lstm_state_dict``)."""
    if isinstance(state.get("lstm"), (list, tuple)):
        from ..convert import lstm_state_dict
        head = "classifier" if "classifier" in state else "regressor"
        state = lstm_state_dict(state, head)
    hidden4 = 4 * hidden_size
    if hidden4 % parts:
        raise ValueError(f"{parts} gate blocks do not divide 4H = {hidden4}")
    rows = hidden4 // parts
    out = {}
    for k, v in state.items():
        v = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v.detach())
        out[k] = (v[index * rows:(index + 1) * rows].clone()
                  if _is_gate_block(v.shape, hidden4) else v.clone())
    return out


class GateParallelLSTM(nn.Module):
    """``nn.LSTM``'s interface (gate order i, f, g, o; state [L*D, B, H];
    layer k > 0 reads the directions' concatenated output) over this
    rank's rows of every gate tensor, as a step loop with the JAX
    ``_cell_scan`` semantics: a right-padded step (past a row's length)
    passes (h, c) through, so the backward direction starts at each row's
    last valid frame, and the output there repeats the held h.

    Each step multiplies the step's input and h by the rank's gate rows,
    all-gathers the 4H gates over the model group and updates the cell,
    replicated.  Parameters keep ``nn.LSTM``'s names, so a model's
    state_dict keys are unchanged."""

    def __init__(self, lstm: nn.LSTM, group, parts: int, index: int):
        super().__init__()
        if lstm.dropout:
            raise ValueError("the gate-parallel LSTM has no dropout")
        self.input_size = lstm.input_size
        self.hidden_size = lstm.hidden_size
        self.num_layers = lstm.num_layers
        self.bidirectional = lstm.bidirectional
        self.group, self.parts, self.index = group, parts, index
        blocks = lstm_block_state_dict(dict(lstm.named_parameters()),
                                       lstm.hidden_size, index, parts)
        for name, value in blocks.items():
            self.register_parameter(name, nn.Parameter(value))

    def _scan(self, x, sfx, h, c, reverse, valid):
        w_ih, w_hh, b_ih, b_hh = (getattr(self, f"{n}{sfx}") for n in (
            "weight_ih", "weight_hh", "bias_ih", "bias_hh"))
        # The input projection of the whole sequence, hoisted out of the
        # recurrence as in the JAX scan.
        xp = _CopyToModel.apply(x, self.group) @ w_ih.t() + b_ih + b_hh
        T = x.shape[1]
        ys = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            local = xp[:, t] + _CopyToModel.apply(h, self.group) @ w_hh.t()
            gates = _GatherGates.apply(local, self.group, self.parts,
                                       self.index)
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            if valid is not None:
                m = valid[:, t, None]
                h_new = torch.where(m, h_new, h)
                c_new = torch.where(m, c_new, c)
            h, c = h_new, c_new
            ys[t] = h
        return torch.stack(ys, dim=1), h, c

    def forward(self, x: torch.Tensor, state, lengths=None):
        """x [B, T, in], state (h, c) [L*D, B, H], ``lengths`` (B valid
        lengths) -> (y [B, T, D*H], (h, c))."""
        valid = None
        if lengths is not None:
            n = torch.as_tensor(lengths, dtype=torch.long, device=x.device)
            valid = torch.arange(x.shape[1], device=x.device)[None] < n[:, None]
        h0, c0 = state
        dirs = ("", "_reverse") if self.bidirectional else ("",)
        hs, cs = [], []
        for layer in range(self.num_layers):
            outs = []
            for d, sfx in enumerate(dirs):
                k = layer * len(dirs) + d
                y, h, c = self._scan(x, f"_l{layer}{sfx}", h0[k], c0[k],
                                     d == 1, valid)
                outs.append(y)
                hs.append(h)
                cs.append(c)
            x = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        return x, (torch.stack(hs), torch.stack(cs))


def shard_lstm_params(mesh: DeviceMesh, model: nn.Module, hidden_size: int
                      ) -> nn.Module:
    """A copy of ``model`` (the decoder or the nVAD) on this rank's device
    with its LSTM gate-block sharded over the mesh's "model" axis
    (``GateParallelLSTM``); the head is replicated."""
    parts, index, group = axis(mesh, "model")
    if model.lstm.hidden_size != hidden_size:
        raise ValueError(f"the model's LSTM has {model.lstm.hidden_size} "
                         f"hidden units, not {hidden_size}")
    sharded = copy.deepcopy(model)
    sharded.lstm = GateParallelLSTM(model.lstm, group, parts, index)
    return sharded.to(mesh_device(mesh))


# -- the data axis -----------------------------------------------------------
def _rows(mesh: DeviceMesh, batch: int) -> slice:
    size, coord, _ = axis(mesh, "data")
    if batch % size:
        raise ValueError(f"a batch of {batch} does not split over a data "
                         f"axis of {size}")
    n = batch // size
    return slice(coord * n, (coord + 1) * n)


def shard_batch(mesh: DeviceMesh, *arrays):
    """This rank's contiguous rows of each batch-leading array (numpy or
    tensor), on its device: rows ``coordinate * B / data ..`` at its
    coordinate on the "data" axis.  Raises where B does not split."""
    dev = mesh_device(mesh)
    out = []
    for a in arrays:
        rows = _rows(mesh, len(a))
        t = a[rows] if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.ascontiguousarray(np.asarray(a)[rows]))
        out.append(t.to(dev))
    return out if len(out) > 1 else out[0]


def batched_vocoder_sharding(mesh: DeviceMesh, state: NetVocoderState,
                             features):
    """This rank's slots of a vocoder stream state for the batch of
    ``features`` [B, T, 20] (every state tensor whose leading dimension is
    B; the state records the slots' place in the batch, so that they draw
    the whole batch's noise) and of the features."""
    B = len(features)
    rows = _rows(mesh, B)
    dev = mesh_device(mesh)
    parts = {k: (v[rows].to(dev) if isinstance(v, torch.Tensor)
                 and v.dim() >= 1 and v.shape[0] == B else v)
             for k, v in state._asdict().items()}
    parts.update(slot_lo=state.slot_lo + rows.start, slots=state.slots or B)
    return NetVocoderState(**parts), shard_batch(mesh, features)


def _gather_rows(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    size, _, group = axis(mesh, "data")
    if size == 1:
        return t
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.cat(out)


@torch.no_grad()
def sharded_fused_word_path(mesh: DeviceMesh, segments, masks,
                            decoder: nn.Module, dec_params, voc_model,
                            voc_params, voc_state: NetVocoderState):
    """The online word program over the mesh (the same math as
    ``FusedDecoderVocoder``): bidirectional decode, the last valid frame
    held over each slot's padding, neural vocoder synthesis.  The N
    segments [N, T, E] (right-padded, ``masks`` [N, T] 1 = valid) and the
    N-stream vocoder state split over "data"; each rank runs its own
    slots, and the ranks gather (lpc [N, T, 20], pcm [N, T*160]) as numpy.
    ``dec_params`` is the decoder's state_dict (None keeps its own)."""
    dev = mesh_device(mesh)
    decoder = copy.deepcopy(decoder).to(dev).eval()
    if dec_params is not None:
        decoder.load_state_dict(dec_params)
    voc_params = {k: v.to(dev) for k, v in voc_params.items()}
    state, x = batched_vocoder_sharding(mesh, voc_state,
                                        np.asarray(segments, np.float32))
    mask = np.asarray(masks)[_rows(mesh, len(masks))]
    lengths = np.rint(mask.sum(axis=1)).astype(np.int64)
    pred, _ = decoder(x, lengths=lengths)
    pcm, _ = net_synthesize_frames(voc_model, voc_params, state,
                                   hold_last_frame(pred, lengths))
    return (_gather_rows(mesh, pred).cpu().numpy(),
            _gather_rows(mesh, pcm).cpu().numpy())


# -- data-parallel training steps ---------------------------------------------
def _sum_over(tensors, group) -> None:
    """Sum each tensor over ``group``, in place, in one collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _summed(mesh: DeviceMesh, value: torch.Tensor) -> torch.Tensor:
    size, _, group = axis(mesh, "data")
    value = value.detach().clone()
    if size > 1:
        dist.all_reduce(value, group=group)
    return value


def _trainer_model(mesh: DeviceMesh, model: nn.Module, hidden: int
                   ) -> nn.Module:
    """``model`` seeded as the port seeds a fresh one, gate-parallel where
    the mesh's model axis is larger than 1."""
    seeded_init(model, 0)
    if axis(mesh, "model")[0] > 1:
        return shard_lstm_params(mesh, model, hidden)
    return model


def decoder_trainer(mesh: DeviceMesh, nb_electrodes: int, hidden: int = 100
                    ) -> DecoderTrainer:
    """The trainer ``sharded_decoder_train_step`` builds: a 2-layer
    bidirectional decoder seeded with 0, on this rank's device."""
    model = BidirectionalSpeechSynthesisModel(
        nb_layer=2, nb_hidden_units=hidden, nb_electrodes=nb_electrodes)
    return DecoderTrainer(_trainer_model(mesh, model, hidden),
                          device=mesh_device(mesh))


def vad_trainer(mesh: DeviceMesh, nb_electrodes: int, hidden: int = 150
                ) -> VadTrainer:
    """The trainer ``sharded_vad_train_step`` builds: a 2-layer nVAD
    seeded with 0, on this rank's device."""
    model = UnidirectionalVoiceActivityDetector(
        nb_layer=2, nb_hidden_units=hidden, nb_electrodes=nb_electrodes)
    return VadTrainer(_trainer_model(mesh, model, hidden),
                      device=mesh_device(mesh))


def sharded_decoder_train_step(mesh: DeviceMesh, x, y, mask,
                               hidden: int = 100,
                               trainer: Optional[DecoderTrainer] = None
                               ) -> torch.Tensor:
    """One data x gate-parallel decoder update on the mesh: this rank's
    rows of the global batch x [B, T, E], y [B, T, F], mask [B, T] (host
    arrays), the masked MSE over the GLOBAL count of valid elements, the
    gradients summed over "data" before the update.  So the update equals
    one on the whole batch, whatever the shards' valid counts.  Returns the
    global loss before the update.  ``trainer`` (``decoder_trainer``) lets
    steps chain; a fresh one is built otherwise."""
    if trainer is None:
        trainer = decoder_trainer(mesh, np.shape(x)[-1], hidden)
    mask = np.asarray(mask, np.float32)
    rows = _rows(mesh, len(mask))
    count = max(float(mask.sum()) * np.shape(y)[-1], 1.0)
    trainer.model.train()
    trainer.optimizer.zero_grad(set_to_none=True)
    pred, md = trainer._run(np.asarray(x)[rows], mask[rows])
    loss = masked_mse(pred, to_device(np.asarray(y)[rows], trainer.device),
                      md, count=count)
    loss.backward()
    size, _, group = axis(mesh, "data")
    if size > 1:
        _sum_over([q.grad for q in trainer.model.parameters()], group)
    trainer.optimizer.step()
    return _summed(mesh, loss)


def sharded_vad_train_step(mesh: DeviceMesh, x, y, mask, hidden: int = 150,
                           trainer: Optional[VadTrainer] = None
                           ) -> torch.Tensor:
    """One data x gate-parallel nVAD TBPTT trial on the mesh: the TBPTT of
    ``VadTrainer.tbptt_trial`` on this rank's rows, each chunk's masked
    cross-entropy over the GLOBAL chunk's valid count and its gradients
    summed over "data" before the update; a chunk with no valid frame in
    the global batch makes no update.  Returns the mean chunk loss of the
    global batch.  ``trainer`` (``vad_trainer``) lets trials chain."""
    if trainer is None:
        trainer = vad_trainer(mesh, np.shape(x)[-1], hidden)
    mask = np.asarray(mask, np.float32)
    B, T = mask.shape
    ck = trainer.chunk
    if T % ck:
        raise ValueError(f"trial length {T} is no multiple of the chunk "
                         f"length {ck}")
    counts = mask.reshape(B, -1, ck).sum(axis=(0, 2))
    rows = _rows(mesh, B)
    xd, yd, md = (to_device(np.asarray(a)[rows], trainer.device)
                  for a in (x, y, mask))
    size, _, group = axis(mesh, "data")
    model = trainer.model
    model.train()
    state = model.create_new_initial_state(xd.shape[0])
    losses = []
    for k, count in enumerate(counts):
        part = slice(k * ck, (k + 1) * ck)
        update = count > 0
        with torch.set_grad_enabled(bool(update)):
            logits, state = model(xd[:, part], state)
            loss = masked_cross_entropy(logits, yd[:, part], md[:, part],
                                        count=max(float(count), 1.0))
        if update:
            trainer.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if size > 1:
                _sum_over([q.grad for q in model.parameters()], group)
            trainer.optimizer.step()
        state = (state[0].detach(), state[1].detach())
        losses.append(loss.detach())
    return _summed(mesh, torch.stack(losses)).mean()


def sharded_vocoder_train_step(mesh: DeviceMesh, trainer, features, signal,
                               noise: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """One data-parallel teacher-forced vocoder update: parameters and
    Adam state replicated (each rank's ``VocoderTrainer``, built alike),
    this rank's rows of features [B, T, 20] and signal [B, T*160], the
    gradients averaged over "data" between ``torch.autograd.grad`` and
    ``VocoderTrainer._apply``, so that clipping and the finiteness check
    see the global gradient.  The jitter ``noise`` [B, T*160] is drawn for
    the global batch from the trainer's generator (the same on every rank)
    when not given, and each rank takes its rows.  Returns the global loss
    before the update."""
    size, _, group = axis(mesh, "data")
    B, T = np.shape(features)[:2]
    rows = _rows(mesh, B)
    if noise is None and trainer.noise_level > 0:
        noise = trainer._draw_noise(B, T * FRAME_SIZE)
    params = trainer.params
    leaves = [params[k] for k in trainer.trainable]
    loss = trainer._loss(params, trainer._tensor(np.asarray(features)[rows]),
                         trainer._tensor(np.asarray(signal)[rows]),
                         None if noise is None else noise[rows])
    grads = [g if g is not None else torch.zeros_like(p) for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    if size > 1:
        _sum_over(grads, group)
        grads = [g / size for g in grads]
    trainer._apply(dict(zip(trainer.trainable, grads)))
    return _summed(mesh, loss) / size
