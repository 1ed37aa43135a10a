"""The LPCNet sample-rate loops: the CUDA kernels and their plain PyTorch
versions.

Counterpart of dss_tpu/ops/pallas/sampler.py:

* bunch 1 — ``sampler_frames`` (csrc/lpcnet_sampler.cu) for
  ``sampler_frames_pallas``;
* bunch S in {2, 4, 8} — ``sampler_frames_bunched``
  (csrc/lpcnet_sampler_bunched.cu) for ``sampler_frames_bunched_pallas``:
  the GRU-A/GRU-B recurrence runs once per S samples, and S heads emit the
  S excitations in order, each after the first corrected by the previous
  excitation and its own LPC prediction.

A kernel and its plain version take the same prepared weights
(``prepare_sampler_weights`` / ``prepare_bunched_sampler_weights``):
embedding tables pre-fused with GRU-A's input rows, the masked recurrent
matrix, and the output heads concatenated.  Gumbel noise is an input, laid
out [T, F, B, 256] by position in the frame for every bunch, so both
versions consume identical noise and a stream's noise does not depend on
the bunch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..vocoder.mulaw import MULAW_LEVELS, mulaw_decode, mulaw_encode
from . import _cuda

ROW_BLOCK = 16    # sparse tile rows (h-dim)
COL_BLOCK = 128   # sparse tile cols (gate-dim)

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def tile_sparse_pattern(mask: np.ndarray):
    """Keep-pattern of a [H, 3H] recurrent mask at [ROW_BLOCK x COL_BLOCK]
    tiles: (pattern, kept_fraction), ``pattern[j]`` the kept row-block
    indices of column group j; (None, 1.0) when nothing is pruned at tile
    granularity or the mask is not tile-divisible."""
    mask = np.asarray(mask)
    H, G = mask.shape
    if H % ROW_BLOCK != 0 or G % COL_BLOCK != 0:
        return None, 1.0
    tiles = mask.reshape(H // ROW_BLOCK, ROW_BLOCK, G // COL_BLOCK, COL_BLOCK)
    keep = np.any(tiles != 0, axis=(1, 3))
    kept = float(keep.mean())
    if kept >= 1.0:
        return None, 1.0
    pattern = tuple(tuple(int(i) for i in np.flatnonzero(keep[:, j]))
                    for j in range(keep.shape[1]))
    return pattern, kept


@torch.no_grad()
def prepare_sampler_weights(params: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """The sampler's weight set from a bunch-1 checkpoint dict (JAX
    layouts, [in, out]), on the checkpoint's device, f32 contiguous."""
    f = {k: v.float() for k, v in params.items()}
    E = f["emb_sig"].shape[1]
    wx = f["gru_a_wx"]
    emb = torch.stack([f[k] @ wx[n * E:(n + 1) * E]
                       for n, k in enumerate(("emb_sig", "emb_pred",
                                              "emb_exc"))])
    wh = f["gru_a_wh"] * f["gru_a_mask"] if "gru_a_mask" in f \
        else f["gru_a_wh"]
    if "fc_out1_b" in f:
        ib = torch.cat([f["fc_out1_b"], f["fc_out2_b"]])
    else:
        ib = torch.zeros(2 * MULAW_LEVELS, device=wx.device)
    w = {
        "emb": emb,
        "wx_a_cond": wx[3 * E:],
        "bx_a": f["gru_a_bx"], "wh_a": wh, "bh_a": f["gru_a_bh"],
        "wx_b": f["gru_b_wx"], "bx_b": f["gru_b_bx"],
        "wh_b": f["gru_b_wh"], "bh_b": f["gru_b_bh"],
        "w_out": torch.cat([f["fc_out1_w"], f["fc_out2_w"]], dim=1),
        "g_out": torch.cat([f["fc_out1_g"], f["fc_out2_g"]]),
        "ib_out": ib,
        "b_out": f["fc_out_b"],
    }
    return {k: v.contiguous() for k, v in w.items()}


def _gru(gx, gh, h):
    H = h.shape[-1]
    r = torch.sigmoid(gx[:, :H] + gh[:, :H])
    z = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
    n = torch.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
    return (1.0 - z) * n + z * h


@torch.no_grad()
def sampler_frames_plain(w: Dict[str, torch.Tensor], carry: Carry,
                         cond: torch.Tensor, lpc: torch.Tensor,
                         temp: torch.Tensor, noise: Optional[torch.Tensor],
                         frame_size: int = 160):
    """Plain version of the kernel.  cond [T,B,CD], lpc [T,B,P], temp [T,B]
    (negative = greedy), noise [T,F,B,256] or None when all greedy.
    Returns ((h_a, h_b, sig_mem, exc), sig [B, T*F])."""
    h_a, h_b, sig_mem, exc = carry
    exc = exc.long()
    T = cond.shape[0]
    GA = h_a.shape[1]
    out = []
    for t in range(T):
        gxc = cond[t] @ w["wx_a_cond"] + w["bx_a"]
        gxbc = cond[t] @ w["wx_b"][GA:] + w["bx_b"]
        lpc_t = lpc[t]
        greedy = (temp[t] < 0)[:, None]
        for i in range(frame_size):
            pred = -(sig_mem * lpc_t).sum(-1)
            gx = (w["emb"][0][mulaw_encode(sig_mem[:, 0])]
                  + w["emb"][1][mulaw_encode(pred)]
                  + w["emb"][2][exc] + gxc)
            h_a = _gru(gx, h_a @ w["wh_a"] + w["bh_a"], h_a)
            h_b = _gru(h_a @ w["wx_b"][:GA] + gxbc,
                       h_b @ w["wh_b"] + w["bh_b"], h_b)
            tt = torch.tanh(h_b @ w["w_out"] + w["ib_out"]) * w["g_out"]
            logits = tt[:, :MULAW_LEVELS] + tt[:, MULAW_LEVELS:] + w["b_out"]
            if noise is not None:
                logits = torch.where(greedy, logits,
                                     logits * temp[t][:, None] + noise[t, i])
            exc = torch.argmax(logits, dim=-1)  # lowest index among ties
            sample = (pred + mulaw_decode(exc)).clamp(-1.0, 1.0)
            sig_mem = torch.cat([sample[:, None], sig_mem[:, :-1]], dim=1)
            out.append(sample)
    sig = torch.stack(out, dim=1)  # [B, T*F]
    return (h_a, h_b, sig_mem, exc), sig


def _check_call(name, w, carry, cond, lpc, temp, noise, frame_size,
                exc_shape) -> None:
    """Shape checks shared by the two wrappers."""
    h_a, h_b, sig_mem, exc = carry
    T, B, CD = cond.shape
    GA, GB, P = h_a.shape[1], h_b.shape[1], sig_mem.shape[1]
    if lpc.shape != (T, B, P) or temp.shape != (T, B) or \
            h_a.shape[0] != B or h_b.shape[0] != B or \
            tuple(exc.shape) != exc_shape:
        raise ValueError(f"{name}: inconsistent shapes")
    if w["wh_a"].shape != (GA, 3 * GA) or w["wx_a_cond"].shape != (CD, 3 * GA) \
            or w["wx_b"].shape != (GA + CD, 3 * GB):
        raise ValueError(f"{name}: weights do not match the state")
    if noise is not None and noise.shape != (T, frame_size, B, MULAW_LEVELS):
        raise ValueError(f"{name}: noise {tuple(noise.shape)}")
    if noise is None and bool((temp >= 0).any()):
        raise ValueError(f"{name}: stochastic frames need noise")


def _check_cuda(name, w, carry, cond, lpc, temp, noise) -> None:
    """What the kernels take: float32, contiguous, 16-byte aligned tensors
    on one CUDA device, GRU widths that are multiples of 4."""
    h_a, h_b, sig_mem, _ = carry
    if cond.device.type != "cuda":
        raise TypeError(f"{name}: needs CUDA or CPU tensors")
    tensors = [cond, lpc, temp, h_a, h_b, sig_mem] + list(w.values()) + (
        [noise] if noise is not None else [])
    for x in tensors:
        if x.device != cond.device or x.dtype != torch.float32 or \
                not x.is_contiguous() or x.data_ptr() % 16:
            raise TypeError(f"{name}: every tensor must be float32, "
                            "contiguous, 16-byte aligned and on one CUDA "
                            "device")
    if h_a.shape[1] % 4 or h_b.shape[1] % 4:
        raise ValueError(f"{name}: the kernel needs GRU widths that are "
                         "multiples of 4")


_W_KEYS = ("emb", "wx_a_cond", "bx_a", "wh_a", "bh_a", "wx_b", "bx_b",
           "wh_b", "bh_b", "w_out", "g_out", "ib_out", "b_out")


def sampler_frames(w: Dict[str, torch.Tensor], carry: Carry,
                   cond: torch.Tensor, lpc: torch.Tensor, temp: torch.Tensor,
                   noise: Optional[torch.Tensor], frame_size: int = 160):
    """Synthesize T frames of F samples for B streams (shapes as in
    ``sampler_frames_plain``).  CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    h_a, h_b, sig_mem, exc = carry
    T, B, CD = cond.shape
    GA, GB, P = h_a.shape[1], h_b.shape[1], sig_mem.shape[1]
    _check_call("sampler_frames", w, carry, cond, lpc, temp, noise,
                frame_size, (B,))
    if cond.device.type == "cpu":
        return sampler_frames_plain(w, carry, cond, lpc, temp, noise,
                                    frame_size)
    _check_cuda("sampler_frames", w, carry, cond, lpc, temp, noise)
    exc_i = exc.to(torch.int32).contiguous()
    sig = torch.empty((B, T * frame_size), dtype=torch.float32,
                      device=cond.device)
    h_a1 = torch.empty_like(h_a)
    h_b1 = torch.empty_like(h_b)
    sig_mem1 = torch.empty_like(sig_mem)
    exc1 = torch.empty_like(exc_i)
    lib = _cuda.library()
    rc = lib.dss_lpcnet_sampler(
        cond.data_ptr(), lpc.data_ptr(), temp.data_ptr(),
        None if noise is None else noise.data_ptr(),
        *[w[k].data_ptr() for k in _W_KEYS],
        h_a.data_ptr(), h_b.data_ptr(), sig_mem.data_ptr(), exc_i.data_ptr(),
        sig.data_ptr(), h_a1.data_ptr(), h_b1.data_ptr(), sig_mem1.data_ptr(),
        exc1.data_ptr(), T, frame_size, B, GA, GB, CD, P,
        _cuda.stream_ptr(cond))
    _cuda.check(rc, "lpcnet_sampler")
    sampler_frames.launches += 1
    return (h_a1, h_b1, sig_mem1, exc1.long()), sig


sampler_frames.launches = 0


# ---- bunch S > 1 -------------------------------------------------------------

BUNCHES = (2, 4, 8)  # the bunch sizes the kernel is built for


def bunch_of(params: Dict[str, torch.Tensor]) -> int:
    """The bunch size of a checkpoint, from its per-lag embedding tables."""
    bunch = 1
    while f"emb_sig_l{bunch}" in params:
        bunch += 1
    return bunch


@torch.no_grad()
def prepare_bunched_sampler_weights(params: Dict[str, torch.Tensor]
                                    ) -> Dict[str, torch.Tensor]:
    """The bunched sampler's weight set from a bunch-S checkpoint dict (JAX
    layouts, [in, out]), on the checkpoint's device, f32 contiguous.

    ``emb`` stacks the 2S+1 tables fused with their band of ``gru_a_wx`` in
    the order of ``bunch_step``'s GRU-A input: sample lags 0..S-1, the
    prediction, excitation lags 0..S-1.  Head j (both halves) sits in
    columns [j*512, (j+1)*512) of ``w_out`` / ``g_out`` / ``ib_out`` and
    [j*256, (j+1)*256) of ``b_out``.  ``corr[j-1]`` holds the pair
    (bunch_exc_emb_b{j}, bunch_pred_emb_b{j})."""
    f = {k: v.float() for k, v in params.items()}
    S = bunch_of(f)
    if S < 2:
        raise ValueError("prepare_bunched_sampler_weights: a bunch-1 "
                         "checkpoint; use prepare_sampler_weights")
    E = f["emb_sig"].shape[1]
    wx = f["gru_a_wx"]
    names = (["emb_sig"] + [f"emb_sig_l{j}" for j in range(1, S)]
             + ["emb_pred", "emb_exc"]
             + [f"emb_exc_l{j}" for j in range(1, S)])
    emb = torch.stack([f[k] @ wx[n * E:(n + 1) * E]
                       for n, k in enumerate(names)])
    wh = f["gru_a_wh"] * f["gru_a_mask"] if "gru_a_mask" in f \
        else f["gru_a_wh"]
    zeros = torch.zeros(MULAW_LEVELS, device=wx.device)
    ws, gs, ibs, bs = [], [], [], []
    for j in range(S):
        sfx = "" if j == 0 else f"_b{j}"
        for n in (1, 2):
            ws.append(f[f"fc_out{n}_w{sfx}"])
            gs.append(f[f"fc_out{n}_g{sfx}"])
            ibs.append(f.get(f"fc_out{n}_b{sfx}", zeros))
        bs.append(f[f"fc_out_b{sfx}"])
    w = {
        "emb": emb,
        "wx_a_cond": wx[len(names) * E:],
        "bx_a": f["gru_a_bx"], "wh_a": wh, "bh_a": f["gru_a_bh"],
        "wx_b": f["gru_b_wx"], "bx_b": f["gru_b_bx"],
        "wh_b": f["gru_b_wh"], "bh_b": f["gru_b_bh"],
        "w_out": torch.cat(ws, dim=1), "g_out": torch.cat(gs),
        "ib_out": torch.cat(ibs), "b_out": torch.cat(bs),
        "corr": torch.stack([torch.stack([f[f"bunch_exc_emb_b{j}"],
                                          f[f"bunch_pred_emb_b{j}"]])
                             for j in range(1, S)]),
    }
    return {k: v.contiguous() for k, v in w.items()}


@torch.no_grad()
def sampler_frames_bunched_plain(w: Dict[str, torch.Tensor], carry: Carry,
                                 cond: torch.Tensor, lpc: torch.Tensor,
                                 temp: torch.Tensor,
                                 noise: Optional[torch.Tensor],
                                 frame_size: int = 160):
    """Plain version of the bunched kernel.  The carry's excitation history
    is [B, S], most recent first; cond [T,B,CD], lpc [T,B,P], temp [T,B]
    (negative = greedy), noise [T,F,B,256] or None when all greedy:
    sub-sample j of step i takes noise position i*S + j.
    Returns ((h_a, h_b, sig_mem, exc [B,S]), sig [B, T*F])."""
    h_a, h_b, sig_mem, exc = carry
    exc = exc.long()
    S = exc.shape[1]
    T = cond.shape[0]
    GA = h_a.shape[1]
    L = MULAW_LEVELS
    emb, corr = w["emb"], w["corr"]
    out = []
    for t in range(T):
        gxc = cond[t] @ w["wx_a_cond"] + w["bx_a"]
        gxbc = cond[t] @ w["wx_b"][GA:] + w["bx_b"]
        lpc_t = lpc[t]
        greedy = (temp[t] < 0)[:, None]
        for i in range(frame_size // S):
            pred = -(sig_mem * lpc_t).sum(-1)
            gx = emb[S][mulaw_encode(pred)] + gxc
            for j in range(S):
                gx = gx + emb[j][mulaw_encode(sig_mem[:, j])] \
                    + emb[S + 1 + j][exc[:, j]]
            h_a = _gru(gx, h_a @ w["wh_a"] + w["bh_a"], h_a)
            h_b = _gru(h_a @ w["wx_b"][:GA] + gxbc,
                       h_b @ w["wh_b"] + w["bh_b"], h_b)
            tt = torch.tanh(h_b @ w["w_out"] + w["ib_out"]) * w["g_out"]
            excs = []
            for j in range(S):
                logits = tt[:, 2 * j * L:(2 * j + 1) * L] \
                    + tt[:, (2 * j + 1) * L:(2 * j + 2) * L] \
                    + w["b_out"][j * L:(j + 1) * L]
                if j > 0:
                    logits = logits + corr[j - 1, 0][excs[-1]] \
                        + corr[j - 1, 1][mulaw_encode(pred)]
                if noise is not None:
                    logits = torch.where(
                        greedy, logits,
                        logits * temp[t][:, None] + noise[t, i * S + j])
                e = torch.argmax(logits, dim=-1)  # lowest index among ties
                sample = (pred + mulaw_decode(e)).clamp(-1.0, 1.0)
                sig_mem = torch.cat([sample[:, None], sig_mem[:, :-1]], dim=1)
                out.append(sample)
                excs.append(e)
                if j + 1 < S:
                    pred = -(sig_mem * lpc_t).sum(-1)
            exc = torch.stack(excs[::-1], dim=1)  # most recent first
    sig = torch.stack(out, dim=1)  # [B, T*F]
    return (h_a, h_b, sig_mem, exc), sig


def sampler_frames_bunched(w: Dict[str, torch.Tensor], carry: Carry,
                           cond: torch.Tensor, lpc: torch.Tensor,
                           temp: torch.Tensor, noise: Optional[torch.Tensor],
                           frame_size: int = 160):
    """Synthesize T frames of F samples for B streams with a bunch-S model
    (shapes as in ``sampler_frames_bunched_plain``; S is read from the
    weights).  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    name = "sampler_frames_bunched"
    h_a, h_b, sig_mem, exc = carry
    T, B, CD = cond.shape
    GA, GB, P = h_a.shape[1], h_b.shape[1], sig_mem.shape[1]
    S = (w["emb"].shape[0] - 1) // 2
    if S not in BUNCHES or frame_size % S or P < S or \
            w["w_out"].shape != (GB, S * 2 * MULAW_LEVELS) or \
            w["corr"].shape != (S - 1, 2, MULAW_LEVELS, MULAW_LEVELS):
        raise ValueError(f"{name}: bunch {S} with frames of {frame_size} "
                         f"and weights of these shapes is not supported")
    _check_call(name, w, carry, cond, lpc, temp, noise, frame_size, (B, S))
    if cond.device.type == "cpu":
        return sampler_frames_bunched_plain(w, carry, cond, lpc, temp, noise,
                                            frame_size)
    _check_cuda(name, w, carry, cond, lpc, temp, noise)
    exc_i = exc.to(torch.int32).contiguous()
    sig = torch.empty((B, T * frame_size), dtype=torch.float32,
                      device=cond.device)
    h_a1 = torch.empty_like(h_a)
    h_b1 = torch.empty_like(h_b)
    sig_mem1 = torch.empty_like(sig_mem)
    exc1 = torch.empty_like(exc_i)
    lib = _cuda.library()
    rc = lib.dss_lpcnet_sampler_bunched(
        cond.data_ptr(), lpc.data_ptr(), temp.data_ptr(),
        None if noise is None else noise.data_ptr(),
        *[w[k].data_ptr() for k in _W_KEYS + ("corr",)],
        h_a.data_ptr(), h_b.data_ptr(), sig_mem.data_ptr(), exc_i.data_ptr(),
        sig.data_ptr(), h_a1.data_ptr(), h_b1.data_ptr(), sig_mem1.data_ptr(),
        exc1.data_ptr(), S, T, frame_size, B, GA, GB, CD, P,
        _cuda.stream_ptr(cond))
    _cuda.check(rc, "lpcnet_sampler_bunched")
    sampler_frames_bunched.launches += 1
    return (h_a1, h_b1, sig_mem1, exc1.long()), sig


sampler_frames_bunched.launches = 0
