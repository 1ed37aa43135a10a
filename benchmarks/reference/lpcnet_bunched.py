"""Plain reference of Bunched LPCNet's sample-rate network (Vipperla et al.,
"Bunched LPCNet", Interspeech 2020, arXiv:2008.04574, on Valin & Skoglund's
LPCNet, arXiv:1810.11846), judged teacher-forced as ``lpcnet.py`` judges
bunch 1.

The two GRUs step once per S samples.  GRU-A's input at a step is, in this
order: the embeddings of mu-law of the S newest samples (``emb_sig`` of the
newest, ``emb_sig_l1 .. l{S-1}`` of the older ones), of the prediction of
the step's first sample (``emb_pred``), of the S newest excitations
(``emb_exc``, ``emb_exc_l1 .. l{S-1}``), and the frame's conditioning;
GRU-B's is [h_a, cond].  Sub-sample j of the step takes head j; for j > 0
it adds ``bunch_exc_emb_b{j}`` at the excitation of sub-sample j - 1 and
``bunch_pred_emb_b{j}`` at mu-law of its own prediction.  A sample's noise
is the bunch-1 judge's draw at the sample's own position in the frame.

S and every width are read from the checkpoint's shapes.  ``fresh_state``
leaves the recurrent states and the excitation history None: the judge
takes them as a fresh stream's at the checkpoint's widths (zeros; S
excitations at the middle level).  A state the program carries holds
``exc`` as [B, S], most recent first.

The rest is the bunch-1 judge's: the excitation behind each of the
program's samples is the mu-law level nearest the sample less the float64
prediction; every embedded prediction is taken as the program rounded it
(sample less level); a clipped sample agrees if the reference's choice
reaches the clip too; the same ``Verdict``; ``precision="bf16"`` is the
control.  Plain PyTorch with TF32 off.
"""

from __future__ import annotations

import torch

from . import lpc as L
from .lpcnet import BLOCK_FRAMES, CONTEXT, QUIET_C0, QUIET_GAIN, SEED, \
    NetState, Verdict, _gru, _rounder, condition, deemphasize, gumbel, \
    load
from .precision import no_tf32

__all__ = ["NetState", "Verdict", "bunch_of", "deemphasize", "fresh_state",
           "judge", "load"]


def bunch_of(params) -> int:
    """S, from the checkpoint's per-lag embedding tables."""
    S = 1
    while f"emb_sig_l{S}" in params:
        S += 1
    return S


def fresh_state(batch: int, device) -> NetState:
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return NetState(None, None, z(batch, L.ORDER), None,
                    z(batch, CONTEXT, 20), z(batch), 0)


def _head(p, hb: torch.Tensor, j: int) -> torch.Tensor:
    """Dual tanh head of sub-sample j, its biases inside the tanh."""
    sfx = "" if j == 0 else f"_b{j}"
    b1, b2 = p.get(f"fc_out1_b{sfx}", 0.0), p.get(f"fc_out2_b{sfx}", 0.0)
    return (torch.tanh(hb @ p[f"fc_out1_w{sfx}"] + b1) * p[f"fc_out1_g{sfx}"]
            + torch.tanh(hb @ p[f"fc_out2_w{sfx}"] + b2)
            * p[f"fc_out2_g{sfx}"] + p[f"fc_out_b{sfx}"])


@torch.no_grad()
@no_tf32()
def judge(params, feats: torch.Tensor, sig: torch.Tensor, state: NetState,
          quiet_sharpen: bool = False, precision: str = "float32"
          ) -> Verdict:
    """feats [B, T, 20] and the program's samples [B, T * 160] over them
    from ``state`` -> the Verdict."""
    dev = sig.device
    rnd = _rounder(precision)
    p = {k: rnd(v.to(dev, torch.float32)) for k, v in params.items()}
    S = bunch_of(p)
    B, T, _ = feats.shape
    N = T * L.FRAME
    GA, GB = p["gru_a_wh"].shape[0], p["gru_b_wh"].shape[0]
    h_a0 = torch.zeros(B, GA, device=dev) if state.h_a is None \
        else state.h_a.to(dev)
    h_b0 = torch.zeros(B, GB, device=dev) if state.h_b is None \
        else state.h_b.to(dev)
    exc0 = torch.full((B, S), 128, dtype=torch.long, device=dev) \
        if state.exc is None else state.exc.to(dev).long().reshape(B, S)
    feats = feats.to(dev, torch.float32)
    cond = rnd(condition(p, torch.cat([state.feat_mem.to(dev), feats], 1)))
    lpc, _ = L.lpc_from_cepstrum(feats[..., :L.BANDS].to(torch.float64))
    corr = torch.clamp(feats[..., L.BANDS + 1] + 0.5, 0.0, 1.0)
    temp = 1.0 + 1.5 * corr
    if quiet_sharpen:
        temp = temp * (1.0 + torch.clamp((QUIET_C0 - feats[..., 0])
                                         * QUIET_GAIN, min=0.0))
    s = sig.to(torch.float64)
    hist = torch.cat([state.sig_mem.to(dev, torch.float64).flip(1), s], 1)
    taps = lpc.repeat_interleave(L.FRAME, dim=1)
    pred = -(hist.unfold(1, L.ORDER, 1)[:, :N].flip(2) * taps).sum(-1)
    levels = torch.as_tensor(L.MULAW_LEVELS, dtype=torch.float64,
                             device=dev)
    v = (s - pred).contiguous()
    hi = torch.searchsorted(levels, v).clamp(1, 255)
    exc = torch.where((v - levels[hi - 1]).abs() <= (levels[hi] - v).abs(),
                      hi - 1, hi)
    pcm = deemphasize(s, state.deemph, precision)
    clip = s.abs() >= 1.0
    off = torch.where(clip, 0.0, (s - (pred + levels[exc])).abs())
    pred_gap = float(off.max()) if off.numel() else 0.0
    # Every sample's prediction as the program rounded it (its sample less
    # the level) where the sample is not clipped.
    mu_pred = L.mulaw_encode(torch.where(clip, pred, s - levels[exc])
                             .float())
    # Step k starts at sample kS; lag j of it is sample kS - 1 - j.
    first = torch.arange(0, N, S, device=dev)
    lags = first[:, None] - 1 - torch.arange(S, device=dev)[None, :]
    mu_sig = L.mulaw_encode(hist[:, L.ORDER + lags].float())    # [B, K, S]
    cond_k = cond.repeat_interleave(L.FRAME // S, dim=1)
    temp_n = temp.repeat_interleave(L.FRAME, dim=1)
    wh = p["gru_a_wh"] * p["gru_a_mask"] if "gru_a_mask" in p \
        else p["gru_a_wh"]
    sfx = [""] + [f"_l{j}" for j in range(1, S)]

    def choices(exc):
        prev = torch.cat([exc0.flip(1), exc], 1)[:, S + lags]   # [B, K, S]
        x_a = rnd(torch.cat(
            [p["emb_sig" + sfx[j]][mu_sig[..., j]] for j in range(S)]
            + [p["emb_pred"][mu_pred[:, ::S]]]
            + [p["emb_exc" + sfx[j]][prev[..., j]] for j in range(S)]
            + [cond_k], -1))
        h_a = _gru(x_a, h_a0, p["gru_a_wx"], wh, p["gru_a_bx"],
                   p["gru_a_bh"])
        del x_a
        x_b = rnd(torch.cat([h_a, cond_k], -1))
        del h_a
        h_b = _gru(x_b, h_b0, p["gru_b_wx"], p["gru_b_wh"], p["gru_b_bx"],
                   p["gru_b_bh"])
        del x_b
        choice = torch.empty((B, N), dtype=torch.long, device=dev)
        for f0 in range(0, T, BLOCK_FRAMES):
            nf = min(BLOCK_FRAMES, T - f0)
            lo, hi = f0 * L.FRAME, (f0 + nf) * L.FRAME
            g = gumbel(SEED, state.frame_ctr + f0, nf, B, dev,
                       state.slot_lo, state.slots)
            g = g.reshape(hi - lo, B, 256).transpose(0, 1)
            hb = rnd(h_b[:, lo // S:hi // S])
            logits = torch.stack([_head(p, hb, j) for j in range(S)], 2
                                 ).reshape(B, hi - lo, 256)
            for j in range(1, S):
                logits[:, j::S] += (
                    p[f"bunch_exc_emb_b{j}"][exc[:, lo + j - 1:hi:S]]
                    + p[f"bunch_pred_emb_b{j}"][mu_pred[:, lo + j:hi:S]])
            choice[:, lo:hi] = torch.argmax(
                logits * temp_n[:, lo:hi, None] + g, dim=-1)
        return choice

    # A clipped sample leaves its excitation open: any level that reaches
    # the clip.  There the reference's own choice stands for it if it
    # reaches the clip too, and the history is run again.
    for _ in range(4):
        choice = choices(exc)
        reach = torch.where(s > 0, pred + levels[choice] >= 1.0 - 1e-6,
                            pred + levels[choice] <= -1.0 + 1e-6)
        fill = torch.where(clip & reach, choice, exc)
        if not bool(clip.any()) or torch.equal(fill, exc):
            break
        exc = fill
    own = torch.clamp(rnd(rnd(pred) + levels[choice]), -1.0, 1.0)
    return Verdict(torch.where(clip, ~reach, choice != exc), pcm, pred_gap,
                   own)
