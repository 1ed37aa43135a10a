"""The word decoder's inference forward (kernel D3, csrc/bilstm_decoder.cu)
and its plain PyTorch version.

``BidirectionalSpeechSynthesisModel`` (models/decoder.py) is a stacked
bidirectional LSTM and a Linear(2H -> F) regressor.  Over a right-padded
batch x [B, Tx, E] with per-row lengths, both versions give

* ``feats`` [B, Tp, F] (Tp >= Tx): the regressor on each row's valid
  frames, and each row's frames past its length holding its last valid
  frame (``models/decoder.py::hold_last_frame``'s rule);
* the final (h, c), each [2L, B, H]: every layer and direction after the
  row's last step, as a packed ``nn.LSTM`` run leaves them.

A row of length 0 keeps its state and gets zero features.

The kernel runs a batch in one launch; the plain version is a Python loop
over the steps, every row and both directions at once.  Both compute every
sum as one chain of fused multiply-adds in a fixed order, which the plain
version spells out: an input projection over the inputs in order, then
``+ (b_ih + b_hh)``; the recurrent product per lane of a pair, lane k over
its ceil(H / 2) columns from k * ceil(H / 2) on, in order, then lane 0 +
lane 1; the regressor over its 2H inputs in order, then ``+ b_out``.  A
fused multiply-add rounds once; the plain version computes it in float64
and rounds to float32 through round-to-odd (``_fma``), which is exact.
Every other operation is one float32 operation, as in the kernel: sigmoid
as 1 / (1 + exp(-x)), the cell as f * c + i * g and o * tanh(c).  So on the card the two agree bit for bit (the kernel calls
libdevice's expf and tanhf, as torch's CUDA exp and tanh do).

CUDA tensors launch the kernel (or raise); CPU tensors take the plain
version.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from . import _cuda

LANES = 2  # lanes a hidden unit in the kernel's recurrent product


class DecoderWeights(NamedTuple):
    """The decoder's parameters, as the kernel reads them."""

    # Per (layer, direction): (w_ih [4H, K], w_hh [4H, H], b_ih, b_hh).
    layers: Tuple[Tuple[torch.Tensor, ...], ...]
    w_out: torch.Tensor                  # [F, 2H]
    b_out: torch.Tensor                  # [F]


def decoder_weights(lstm: nn.LSTM, regressor: nn.Linear) -> DecoderWeights:
    """The parameters of a bidirectional ``nn.LSTM`` with biases and its
    regressor, in the kernel's order: layer by layer, forward then
    backward."""
    layers = []
    for l in range(lstm.num_layers):
        for sfx in ("", "_reverse"):
            layers.append(tuple(getattr(lstm, f"{n}_l{l}{sfx}") for n in
                                ("weight_ih", "weight_hh", "bias_ih",
                                 "bias_hh")))
    return DecoderWeights(tuple(layers), regressor.weight, regressor.bias)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c), rounded once, on float64 tensors that hold
    float32 values.  a * b is exact in float64; the sum is rounded to odd
    (its exact error by TwoSum), and float32 rounding of a value rounded to
    odd with 29 more bits is the correctly rounded fma."""
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float().double()


def _sigmoid(v: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(1.0 + torch.exp(-v))


@torch.no_grad()
def bilstm_decode_plain(x: torch.Tensor, lengths, w: DecoderWeights,
                        state: Optional[Tuple[torch.Tensor, torch.Tensor]]
                        = None, frames: Optional[int] = None):
    """Plain version of D3 on x's device: (feats [B, frames or Tx, F],
    (h_n, c_n) [2L, B, H])."""
    B, Tx, _ = x.shape
    L = len(w.layers) // 2
    H = w.layers[0][1].shape[1]
    F = w.w_out.shape[0]
    Tp = Tx if frames is None else frames
    dev = x.device
    n = torch.as_tensor(lengths, device=dev).reshape(B).long().clamp(0, Tx)
    rows = torch.arange(B, device=dev)
    nc = -(-H // LANES)
    h_all, c_all = [], []
    inp = x.float()
    for l in range(L):
        wd = [w.layers[2 * l + d] for d in (0, 1)]
        # Input projections [2, B, Tx, 4H]: one fma chain over the inputs.
        W = torch.stack([t[0] for t in wd]).double()       # [2, 4H, K]
        acc = torch.zeros((2, B, Tx, 4 * H), dtype=torch.float64, device=dev)
        xi = inp.double()
        for k in range(W.shape[2]):
            acc = _fma(W[:, None, None, :, k], xi[None, :, :, k, None], acc)
        bias = torch.stack([t[2] + t[3] for t in wd])      # [2, 4H]
        xp = acc.float() + bias[:, None, None, :]
        # Recurrent weights by lane: [2, 4H, LANES, nc], zero past H.
        Wh = torch.zeros((2, 4 * H, LANES * nc), dtype=torch.float64,
                         device=dev)
        Wh[..., :H] = torch.stack([t[1] for t in wd]).double()
        Wh = Wh.reshape(2, 4 * H, LANES, nc)
        if state is None:
            h = torch.zeros((2, B, H), device=dev)
            c = torch.zeros((2, B, H), device=dev)
        else:
            h = state[0][2 * l:2 * l + 2].float().clone()
            c = state[1][2 * l:2 * l + 2].float().clone()
        y = torch.zeros((B, Tx, 2, H), device=dev)
        for s in range(int(n.max()) if B else 0):
            live = (s < n)[None, :, None]                   # [1, B, 1]
            t = torch.stack([torch.full_like(n, s), n - 1 - s]).clamp(
                0, Tx - 1)
            xq = torch.stack([xp[d, rows, t[d]] for d in (0, 1)])  # [2, B, 4H]
            hp = torch.zeros((2, B, LANES * nc), dtype=torch.float64,
                             device=dev)
            hp[..., :H] = h.double()
            hp = hp.reshape(2, B, 1, LANES, nc)
            part = torch.zeros((2, B, 4 * H, LANES), dtype=torch.float64,
                               device=dev)
            for j in range(nc):
                part = _fma(Wh[:, None, :, :, j], hp[..., j], part)
            part = part.float()
            tot = part[..., 0] + part[..., 1]
            pre = xq + tot
            i_g = _sigmoid(pre[..., :H])
            f_g = _sigmoid(pre[..., H:2 * H])
            g_g = torch.tanh(pre[..., 2 * H:3 * H])
            o_g = _sigmoid(pre[..., 3 * H:])
            c_new = f_g * c + i_g * g_g
            h_new = o_g * torch.tanh(c_new)
            c = torch.where(live, c_new, c)
            h = torch.where(live, h_new, h)
            for d in (0, 1):
                ok = live[0, :, 0]
                y[rows[ok], t[d][ok], d] = h_new[d][ok]
        h_all.append(h)
        c_all.append(c)
        inp = y.reshape(B, Tx, 2 * H)
    # The regressor: one fma chain over the 2H inputs, then the bias.
    acc = torch.zeros((B, Tx, F), dtype=torch.float64, device=dev)
    Wo = w.w_out.double()
    yi = inp.double()
    for k in range(2 * H):
        acc = _fma(Wo[None, None, :, k], yi[:, :, k, None], acc)
    out = acc.float() + w.b_out
    idx = torch.minimum(torch.arange(Tp, device=dev)[None],
                        (n - 1).clamp(min=0)[:, None])
    feats = out.gather(1, idx.clamp(max=Tx - 1)[..., None].expand(B, Tp, F))
    feats = torch.where((n > 0)[:, None, None], feats, torch.zeros_like(feats))
    return feats, (torch.cat(h_all), torch.cat(c_all))


@lru_cache(maxsize=16)
def kernel_plan(E: int, H: int, L: int, F: int) -> Dict[str, object]:
    """What the kernel takes at these widths (inputs E, hidden H, layers L,
    outputs F): ``max_hidden``, the widest H whose recurrent weights a
    block keeps in registers; ``smem_bytes`` a block asks for;
    ``supported``; the ``cluster`` size, ``threads`` a block and
    ``max_layers``.  Loads the built kernels (a CUDA toolkit)."""
    out = (ctypes.c_int * 6)()
    _cuda.check(_cuda.library().dss_bilstm_plan(E, H, L, F, out),
                "bilstm_plan")
    return dict(max_hidden=out[0], smem_bytes=out[1], supported=bool(out[2]),
                cluster=out[3], threads=out[4], max_layers=out[5])


def bilstm_decode(x: torch.Tensor,
                  lengths: Union[torch.Tensor, Sequence[int]],
                  w: DecoderWeights,
                  state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  frames: Optional[int] = None):
    """The decoder's inference forward over x [B, Tx, E] float32 with
    ``lengths`` (B valid lengths: host ints, or an int tensor on x's
    device, read by the kernel there) from ``state`` (h0, c0), each [2L, B,
    H] (None: zeros).  Returns (feats [B, frames, F], (h_n, c_n)); frames
    defaults to Tx and may not be less.  Forward only: inputs that would
    need a gradient are refused."""
    B, Tx, E = x.shape
    L = len(w.layers) // 2
    H = w.layers[0][1].shape[1]
    F = w.w_out.shape[0]
    Tp = Tx if frames is None else int(frames)
    if Tp < Tx:
        raise ValueError(f"bilstm_decode: frames={Tp} < the input's {Tx}")
    tensors = [x, w.w_out, w.b_out, *[t for ws in w.layers for t in ws]] \
        + (list(state) if state is not None else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("bilstm_decode: needs float32 inputs, weights and "
                        "state")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("bilstm_decode: forward only; with gradients on, "
                         "its inputs must not require grad")
    if any(t.device != x.device for t in tensors):
        raise ValueError("bilstm_decode: tensors on more than one device")
    if x.device.type == "cpu":
        return bilstm_decode_plain(x, lengths, w, state, Tp)
    if x.device.type != "cuda":
        raise TypeError(f"bilstm_decode: needs a CUDA or CPU tensor, got "
                        f"{x.device}")
    plan = kernel_plan(E, H, L, F)
    if not plan["supported"]:
        raise ValueError(f"bilstm_decode: the kernel does not take E={E}, "
                         f"H={H}, L={L}, F={F} (H <= {plan['max_hidden']}, "
                         f"L <= {plan['max_layers']})")
    if state is not None and any(tuple(t.shape) != (2 * L, B, H)
                                 for t in state):
        raise ValueError(f"bilstm_decode: state must be {[2 * L, B, H]}")
    n = (lengths if isinstance(lengths, torch.Tensor)
         else torch.as_tensor(lengths)).reshape(B)
    n = n.to(device=x.device, dtype=torch.int32)
    x = x.contiguous()
    weights = [t.contiguous() for ws in w.layers for t in ws]
    w_out, b_out = w.w_out.contiguous(), w.b_out.contiguous()
    if state is not None:
        state = tuple(t.contiguous() for t in state)
    f32 = dict(dtype=torch.float32, device=x.device)
    feats = torch.empty((B, Tp, F), **f32)
    h_n = torch.empty((2 * L, B, H), **f32)
    c_n = torch.empty((2 * L, B, H), **f32)
    xp = torch.empty((B, 2, Tx, 4 * H), **f32)
    y0 = torch.empty((B, Tx, 2 * H), **f32)
    y1 = torch.empty((B, Tx, 2 * H), **f32) if L > 1 else y0
    ptrs = (ctypes.c_void_p * len(weights))(*[t.data_ptr() for t in weights])
    rc = _cuda.library().dss_bilstm_decoder(
        x.data_ptr(), n.data_ptr(),
        state[0].data_ptr() if state is not None else None,
        state[1].data_ptr() if state is not None else None,
        ptrs, w_out.data_ptr(), b_out.data_ptr(), xp.data_ptr(),
        y0.data_ptr(), y1.data_ptr(), feats.data_ptr(), h_n.data_ptr(),
        c_n.data_ptr(), B, Tx, Tp, E, H, L, F, _cuda.stream_ptr(x))
    _cuda.check(rc, "bilstm_decode")
    bilstm_decode.launches += 1
    return feats, (h_n, c_n)


bilstm_decode.launches = 0
