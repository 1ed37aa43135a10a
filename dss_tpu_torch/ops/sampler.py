"""The LPCNet sample-rate loop: the CUDA kernel and its plain PyTorch
versions.

Counterpart of dss_tpu/ops/pallas/sampler.py.  Its two entries stay two
entries here, each with its own plain version and launch counter, and both
launch the one kernel of csrc/lpcnet_sampler_bunched.cu:

* bunch 1 — ``sampler_frames`` for ``sampler_frames_pallas`` (the kernel
  at S = 1, excitation history [B]);
* bunch S in {2, 4, 8} — ``sampler_frames_bunched`` for
  ``sampler_frames_bunched_pallas``: the GRU-A/GRU-B recurrence runs once
  per S samples, and S heads emit the S excitations in order, each after
  the first corrected by the previous excitation and its own LPC
  prediction.

The kernel and the plain versions take the same prepared weights
(``prepare_sampler_weights`` / ``prepare_bunched_sampler_weights``):
embedding tables pre-fused with GRU-A's input rows, the masked recurrent
matrix, and the output heads concatenated.  The plain versions multiply by
the dense masked matrix ``wh_a``.  The kernel reads only its kept
[ROW_BLOCK x COL_BLOCK] tiles (``compact_gru_a_tiles``), cut into the
shares of the ``CLUSTER`` thread blocks of a cluster that run one stream
(``cluster_layout``, built at the first launch with a weight set): each
block keeps its share of every dense weight in its shared memory for the
whole launch.  Gumbel noise is an input, laid
out [T, F, B, 256] by position in the frame for every bunch, so both
versions consume identical noise and a stream's noise does not depend on
the bunch.
"""

from __future__ import annotations

import ctypes
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


CLUSTER = 8          # thread blocks per stream, as the kernel is built


def compact_gru_a_tiles(wh: np.ndarray, mask: Optional[np.ndarray] = None):
    """The kept [ROW_BLOCK x COL_BLOCK] tiles of the masked recurrent matrix
    ``wh`` [H, 3H] as one contiguous array: (tiles [K, ROW_BLOCK,
    COL_BLOCK] float32, index [K, 2] int32 of (row block, column group)),
    column groups in order and each group's row blocks in order.  Which
    tiles are kept is ``tile_sparse_pattern(mask)``; with no mask, nothing
    pruned, or widths that the tile does not divide, every tile is kept,
    the ragged ones at the edges zero-padded."""
    wh = np.asarray(wh, np.float32)
    H, G = wh.shape
    nrb, ncg = -(-H // ROW_BLOCK), -(-G // COL_BLOCK)
    pattern = tile_sparse_pattern(mask)[0] if mask is not None else None
    if pattern is None:
        pattern = (tuple(range(nrb)),) * ncg
    index = np.array([(i, j) for j, rows in enumerate(pattern) for i in rows],
                     np.int32).reshape(-1, 2)
    padded = np.zeros((nrb * ROW_BLOCK, ncg * COL_BLOCK), np.float32)
    padded[:H, :G] = wh
    tiles = padded.reshape(nrb, ROW_BLOCK, ncg, COL_BLOCK).transpose(
        0, 2, 1, 3)[index[:, 0], index[:, 1]]
    return np.ascontiguousarray(tiles), index


def scatter_gru_a_tiles(tiles: np.ndarray, index: np.ndarray, H: int
                        ) -> np.ndarray:
    """The dense [H, 3H] matrix that ``compact_gru_a_tiles`` compacted."""
    nrb, ncg = -(-H // ROW_BLOCK), -(-3 * H // COL_BLOCK)
    out = np.zeros((nrb, ncg, ROW_BLOCK, COL_BLOCK), np.float32)
    out[index[:, 0], index[:, 1]] = tiles
    return out.transpose(0, 2, 1, 3).reshape(
        nrb * ROW_BLOCK, ncg * COL_BLOCK)[:H, :3 * H]


def gru_a_cluster_layout(tiles: np.ndarray, index: np.ndarray, H: int,
                         n_b: int, N: int) -> Dict[str, np.ndarray]:
    """GRU-A's kept tiles cut into the shares of N blocks, as the kernel
    reads them.

    Block r owns the units [u0[r], u0[r+1]) (multiples of 4), chosen so that
    the bytes a block keeps (its part of the kept tiles plus its ``n_b``
    wide rows of gru_b_wx) are balanced.  Its local column of gate q and
    local unit ul is q * nuM + ul, with nuM the widest block's unit count.
    A work item is one column of one kept tile: its ROW_BLOCK weights (zeros
    below a ragged edge) and ``work[r, e] = (first row, slot * 3 * nuM +
    local column)``, where slots number a column's kept row blocks in
    order.  Items of adjacent columns of a tile are adjacent, so the
    threads of a warp read the same ROW_BLOCK states.  ``tiles[r]`` holds
    the weights in groups of 32 items, [group, quarter, item, 4]: the 32
    threads of a warp read 512 contiguous bytes per quarter of the rows.
    ``cnt[r, lc]`` is the number of slots to add for local column lc."""
    H3 = 3 * H
    if H % 4:
        raise ValueError("gru_a_cluster_layout: the kernel needs a GRU-A "
                         f"width that is a multiple of 4, not {H}")
    ncg = -(-H3 // COL_BLOCK)
    kept = [[] for _ in range(ncg)]          # per column group: (row block, k)
    for k, (i, j) in enumerate(index):
        kept[int(j)].append((int(i), k))
    # Balanced unit ranges, in quads of units.
    u = np.arange(H)
    per_unit = np.zeros(H)
    for q in range(3):
        per_unit += np.array([len(kept[c // COL_BLOCK]) for c in q * H + u]
                             ) * ROW_BLOCK * 4
    cost = (per_unit + 4 * n_b).reshape(-1, 4).sum(1)
    cum = np.cumsum(cost)
    u0 = [0] + [4 * int(np.searchsorted(cum, cum[-1] * r / N, side="left"))
                for r in range(1, N)] + [H]
    u0 = np.maximum.accumulate(np.array(u0, np.int32))
    nuM = max(4, int(np.diff(u0).max()))
    NAl = 3 * nuM
    blocks = []
    for r in range(N):
        ua, ub = int(u0[r]), int(u0[r + 1])
        data, work = [], []
        cnt = np.zeros(NAl, np.int32)
        for q in range(3):
            c = q * H + ua
            while c < q * H + ub:
                j = c // COL_BLOCK
                c1 = min(q * H + ub, (j + 1) * COL_BLOCK)
                lc0 = q * nuM + (c - q * H - ua)
                cnt[lc0:lc0 + c1 - c] = len(kept[j])
                for slot, (i, k) in enumerate(kept[j]):
                    strip = tiles[k][:, c - j * COL_BLOCK:c1 - j * COL_BLOCK]
                    data.append(np.ascontiguousarray(strip.T))
                    work += [(i * ROW_BLOCK, slot * NAl + lc0 + x)
                             for x in range(c1 - c)]
                c = c1
        blocks.append((np.concatenate(data) if data
                       else np.zeros((0, ROW_BLOCK), np.float32),
                       np.array(work, np.int32).reshape(-1, 2), cnt))
    wmax = -(-max(1, max(len(w) for _, w, _ in blocks)) // 32) * 32
    items = np.zeros((N, wmax, ROW_BLOCK), np.float32)
    out = dict(u0=u0, nwork=np.array([len(w) for _, w, _ in blocks], np.int32),
               work=np.zeros((N, wmax, 2), np.int32),
               cnt=np.stack([c for _, _, c in blocks]),
               nuM=nuM, maxslots=max(len(k) for k in kept))
    for r, (d, w, _) in enumerate(blocks):
        items[r, :len(d)] = d
        out["work"][r, :len(w)] = w
    out["tiles"] = np.ascontiguousarray(
        items.reshape(N, wmax // 32, 32, ROW_BLOCK // 4, 4).transpose(
            0, 1, 3, 2, 4))
    return out


def gru_a_layout_product(lay: Dict[str, np.ndarray], h: np.ndarray
                         ) -> np.ndarray:
    """h [H] @ (wh * mask) [H, 3H] computed as the kernel computes it from a
    ``gru_a_cluster_layout``: per block, each work item's sum into its
    slot, the slots of a column added in order."""
    u0, nuM = lay["u0"], lay["nuM"]
    H, NAl = int(u0[-1]), 3 * lay["nuM"]
    hp = np.zeros(-(-H // ROW_BLOCK) * ROW_BLOCK, np.float32)
    hp[:H] = h
    out = np.zeros(3 * H, np.float32)
    for r in range(len(u0) - 1):
        n = int(lay["nwork"][r])
        row0, dst = lay["work"][r, :n].T
        part = np.zeros(lay["maxslots"] * NAl, np.float32)
        rows = row0[:, None] + np.arange(ROW_BLOCK)[None, :]
        items = lay["tiles"][r].transpose(0, 2, 1, 3).reshape(-1, ROW_BLOCK)
        part[dst] = (items[:n] * hp[rows]).sum(1)
        part = part.reshape(lay["maxslots"], NAl)
        ua, nu = int(u0[r]), int(u0[r + 1] - u0[r])
        for lc in range(NAl):
            q, ul = divmod(lc, nuM)
            if ul < nu:
                out[q * H + ua + ul] = part[:lay["cnt"][r, lc], lc].sum()
    return out


def build_cluster_layout(w: Dict[str, torch.Tensor], N: int
                         ) -> Dict[str, object]:
    """The per-block arrays of the kernel for a cluster of N blocks, on the
    weights' device.  GRU-A: the tiles of the masked matrix ``w["wh_a"]``
    that hold a nonzero weight, compacted and cut by
    ``gru_a_cluster_layout``.  The heads, cut by level: block r computes
    the S * 256 / N levels from r * nl on, whose two half-head columns are
    gathered into ``w_out`` [N, GB, 2 nl] (a level's two halves side by
    side), ``g_out`` and ``ib_out`` [N, 2 nl] and ``b_out`` [N, nl]."""
    dev = w["wh_a"].device
    wh = w["wh_a"].cpu().numpy()
    tiles, index = compact_gru_a_tiles(wh, wh != 0)
    lay = gru_a_cluster_layout(tiles, index, wh.shape[0],
                               w["wh_b"].shape[1], N)
    lay = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
           else v for k, v in lay.items()}
    L = MULAW_LEVELS
    level = torch.arange(w["b_out"].numel(), device=dev).reshape(N, -1)
    c1 = (level // L) * 2 * L + level % L
    cols = torch.stack([c1, c1 + L], dim=2).reshape(N, -1)  # [N, 2 nl]
    lay["w_out"] = w["w_out"][:, cols].permute(1, 0, 2).contiguous()
    lay["g_out"] = w["g_out"][cols].contiguous()
    lay["ib_out"] = w["ib_out"][cols].contiguous()
    lay["b_out"] = w["b_out"][level].contiguous()
    return lay


def cluster_layout(w: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """``build_cluster_layout`` at the kernel's cluster size, built at the
    first launch with this weight set and kept in it."""
    if "cluster_layout" not in w:
        w["cluster_layout"] = build_cluster_layout(w, CLUSTER)
    return w["cluster_layout"]


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


_W_KEYS = ("emb", "wx_a_cond", "bx_a", "wh_a", "bh_a", "wx_b", "bx_b",
           "wh_b", "bh_b", "w_out", "g_out", "ib_out", "b_out")
# The kernel's weight arguments, in its order: the dense ones from the weight
# dict, then the per-block ones from the cluster layout.
_KERNEL_W = ("emb", "wx_a_cond", "bx_a", "bh_a", "wx_b", "bx_b", "wh_b",
             "bh_b")
_KERNEL_LAYOUT = ("tiles", "work", "nwork", "cnt", "u0", "w_out", "g_out",
                  "ib_out", "b_out")


def _check_cuda(name, w, carry, cond, lpc, temp, noise) -> None:
    """What the kernel takes: float32, contiguous, 16-byte aligned tensors
    on one CUDA device, GRU widths that are multiples of 4."""
    h_a, h_b, sig_mem, _ = carry
    if cond.device.type != "cuda":
        raise TypeError(f"{name}: needs CUDA or CPU tensors")
    tensors = [cond, lpc, temp, h_a, h_b, sig_mem] \
        + [w[k] for k in _W_KEYS] \
        + ([w["corr"]] if "corr" in w else []) \
        + ([noise] if noise is not None else [])
    for x in tensors:
        if x.device != cond.device or x.dtype != torch.float32 or \
                not x.is_contiguous() or x.data_ptr() % 16:
            raise TypeError(f"{name}: every tensor must be float32, "
                            "contiguous, 16-byte aligned and on one CUDA "
                            "device")
    if h_a.shape[1] % 4 or h_b.shape[1] % 4:
        raise ValueError(f"{name}: the kernel needs GRU widths that are "
                         "multiples of 4")


def _plan_args(w, S, frame_size, CD, P):
    lay = cluster_layout(w)
    GA, GB = w["wh_a"].shape[0], w["wh_b"].shape[0]
    return lay, (S, frame_size, GA, GB, CD, P, lay["nuM"],
                 lay["work"].shape[1], lay["maxslots"])


def kernel_plan(w: Dict[str, torch.Tensor], S: int, cond_dim: int,
                lpc_order: int, frame_size: int = 160) -> Dict[str, int]:
    """What a launch with these weights would use on the card: the cluster
    size, the shared-memory bytes and the resident weight bytes per block,
    which of the three split weights are resident, and how many clusters
    the card runs at once.  Needs the built kernels (a CUDA machine)."""
    _, dims = _plan_args(w, S, frame_size, cond_dim, lpc_order)
    out = (ctypes.c_int * 7)()
    _cuda.check(_cuda.library().dss_lpcnet_sampler_plan(*dims, out),
                "lpcnet_sampler_plan")
    if out[6] != CLUSTER:
        raise RuntimeError(f"the kernel is built for clusters of {out[6]}, "
                           f"the layout for {CLUSTER}")
    return dict(cluster=out[6], smem_bytes=out[0], resident_bytes=out[1],
                gru_a_tiles_resident=bool(out[2]),
                gru_b_wx_resident=bool(out[3]), heads_resident=bool(out[4]),
                max_active_clusters=out[5])


def _launch(name, w, carry, cond, lpc, temp, noise, frame_size, S):
    """Checks, allocates and launches the kernel at bunch S; the carry's
    excitation history is [B, S] here."""
    h_a, h_b, sig_mem, exc = carry
    T, B, CD = cond.shape
    P = sig_mem.shape[1]
    _check_cuda(name, w, carry, cond, lpc, temp, noise)
    lay, dims = _plan_args(w, S, frame_size, CD, P)
    exc_i = exc.to(torch.int32).contiguous()
    sig = torch.empty((B, T * frame_size), dtype=torch.float32,
                      device=cond.device)
    h_a1 = torch.empty_like(h_a)
    h_b1 = torch.empty_like(h_b)
    sig_mem1 = torch.empty_like(sig_mem)
    exc1 = torch.empty_like(exc_i)
    rc = _cuda.library().dss_lpcnet_sampler_bunched(
        cond.data_ptr(), lpc.data_ptr(), temp.data_ptr(),
        None if noise is None else noise.data_ptr(),
        *[w[k].data_ptr() for k in _KERNEL_W],
        w["corr"].data_ptr() if S > 1 else None,
        *[lay[k].data_ptr() for k in _KERNEL_LAYOUT],
        h_a.data_ptr(), h_b.data_ptr(), sig_mem.data_ptr(), exc_i.data_ptr(),
        sig.data_ptr(), h_a1.data_ptr(), h_b1.data_ptr(), sig_mem1.data_ptr(),
        exc1.data_ptr(), S, T, frame_size, B, *dims[2:],
        _cuda.stream_ptr(cond))
    _cuda.check(rc, name)
    return (h_a1, h_b1, sig_mem1, exc1.long()), sig


def sampler_frames(w: Dict[str, torch.Tensor], carry: Carry,
                   cond: torch.Tensor, lpc: torch.Tensor, temp: torch.Tensor,
                   noise: Optional[torch.Tensor], frame_size: int = 160):
    """Synthesize T frames of F samples for B streams (shapes as in
    ``sampler_frames_plain``).  CUDA tensors launch the kernel at S = 1;
    CPU tensors take the plain version."""
    h_a, h_b, sig_mem, exc = carry
    B = cond.shape[1]
    if w["emb"].shape[0] != 3:
        raise ValueError("sampler_frames: not a bunch-1 weight set")
    _check_call("sampler_frames", w, carry, cond, lpc, temp, noise,
                frame_size, (B,))
    if cond.device.type == "cpu":
        return sampler_frames_plain(w, carry, cond, lpc, temp, noise,
                                    frame_size)
    (h_a1, h_b1, sig_mem1, exc1), sig = _launch(
        "sampler_frames", w, (h_a, h_b, sig_mem, exc[:, None]), cond, lpc,
        temp, noise, frame_size, 1)
    sampler_frames.launches += 1
    return (h_a1, h_b1, sig_mem1, exc1[:, 0]), sig


sampler_frames.launches = 0


# ---- bunch S > 1 -------------------------------------------------------------

BUNCHES = (2, 4, 8)  # the bunch sizes above 1 the kernel is built for


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
    B = cond.shape[1]
    GB, P = h_b.shape[1], sig_mem.shape[1]
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
    out = _launch(name, w, carry, cond, lpc, temp, noise, frame_size, S)
    sampler_frames_bunched.launches += 1
    return out


sampler_frames_bunched.launches = 0
