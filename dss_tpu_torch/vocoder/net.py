"""Neural autoregressive LPCNet vocoder (counterpart of
dss_tpu/vocoder/net.py).

* frame-rate network: two causal 3-tap convs + two dense layers (tanh)
  mapping the 20 features to a 128-dim conditioning vector per frame;
* sample-rate network per 16 kHz sample: mu-law embeddings of (last
  sample, LPC prediction, last excitation), GRU-A (reset-after, masked
  recurrent matrix), GRU-B, dual tanh heads over 256 mu-law levels, and
  Gumbel-max sampling; the excitation plus the LPC prediction is the next
  sample;
* at bunch S > 1 (the b2/b4/b8 checkpoints) the two GRUs step once per S
  samples: the step sees the last S samples and S excitations through
  per-lag embedding tables and emits S excitations through per-sub-sample
  heads, each after the first corrected by [256, 256] embeddings of the
  previous excitation of the bunch and of its own LPC prediction.

Parameters stay a dict of tensors in the JAX package's layouts ([in, out]
matrices), so checkpoints and the tests carry over unchanged.  The sample
loop runs in the sampler kernel (ops/sampler.py) in fixed 50-frame blocks,
each block's LPC in one launch before it (ops/cepstrum_lpc.py) and its
de-emphasis in one after it (ops/deemphasis.py).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import cepstrum_lpc as _cepstrum_lpc
from ..ops import deemphasis as _deemphasis
# The module, not its names: ops/sampler.py imports vocoder/mulaw.py, so
# either of the two may be half-imported when this line runs.
from ..ops import sampler as _sampler
from ..utils import tracing
from .lpc import FRAME_SIZE, LPC_ORDER, NB_BANDS, NB_FEATURES
from .mulaw import MULAW_LEVELS, mulaw_decode, mulaw_encode

EMBED_DIM = 128
COND_DIM = 128
GRU_A_UNITS = 384
GRU_B_UNITS = 32
CONV_WIDTH = 3
FEAT_CONTEXT = 2 * (CONV_WIDTH - 1)  # left context of the two causal convs

# Canonical synthesis block: 50 frames = 8000 samples.  Every per-frame
# computation runs at this block shape, so chunked synthesis equals
# single-shot synthesis whenever calls are whole blocks.
COND_BLOCK = 50
DEEMPH_BLOCK = COND_BLOCK * FRAME_SIZE

# Gumbel tail cap: forbids only picks whose probability ratio is below
# e^-8/temp (the Gumbel-argmax form of LPCNet's probability floor), which
# keeps rare huge draws from igniting crackle in post-speech silence.
NOISE_CAP = 8.0

# Energy-gated sharpening (``quiet_sharpen``): frames with Bark-cepstral c0
# below QUIET_C0 sample at temperature scaled by 1 + (QUIET_C0 - c0) * GAIN.
QUIET_C0 = -12.0
QUIET_GAIN = 0.5

Params = Dict[str, torch.Tensor]


class LPCNetModel:
    """Hyperparameters + functional network pieces.  ``bunch`` is the
    number of samples per sample-rate-network step; it must divide the
    160-sample frame."""

    def __init__(self, gru_a_units: int = GRU_A_UNITS,
                 gru_b_units: int = GRU_B_UNITS, cond_dim: int = COND_DIM,
                 embed_dim: int = EMBED_DIM, bunch: int = 1):
        if FRAME_SIZE % bunch or not 1 <= bunch <= LPC_ORDER:
            raise ValueError(f"bunch {bunch} must divide the frame and lie "
                             f"in 1..{LPC_ORDER}")
        self.gru_a_units = gru_a_units
        self.gru_b_units = gru_b_units
        self.cond_dim = cond_dim
        self.embed_dim = embed_dim
        self.bunch = bunch

    @classmethod
    def from_params(cls, params: Params) -> "LPCNetModel":
        """The architecture from a checkpoint's shapes (the bunch from its
        per-lag embedding tables)."""
        return cls(gru_a_units=params["gru_a_wh"].shape[0],
                   gru_b_units=params["gru_b_wh"].shape[0],
                   cond_dim=params["fc1_w"].shape[0],
                   embed_dim=params["emb_sig"].shape[1],
                   bunch=_sampler.bunch_of(params))

    # -- parameters ----------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> Params:
        """Fresh parameters: the JAX package's keys, shapes and dtypes
        (float32), Glorot-uniform matrices and embeddings drawn from
        ``generator`` (on its device, in the JAX dict's key order), ones for
        the head gains and the mask, zeros for the biases.  The stream is the
        port's own: the same seed does not give the JAX draws."""
        dev = resolve_device(device)
        S = self.bunch
        ed, cd = self.embed_dim, self.cond_dim
        ga, gb = self.gru_a_units, self.gru_b_units
        L = MULAW_LEVELS

        def g(shape):
            lim = float(np.sqrt(6.0 / (shape[0] + shape[1])))
            u = torch.rand(shape, generator=generator,
                           device=generator.device)
            return ((2.0 * u - 1.0) * lim).to(dev)

        def ones(n):
            return torch.ones(n, device=dev)

        def zeros(n):
            return torch.zeros(n, device=dev)

        p: Params = {}
        for j in range(1, S):
            p[f"emb_sig_l{j}"] = g((L, ed))
            p[f"emb_exc_l{j}"] = g((L, ed))
            p[f"fc_out1_w_b{j}"] = g((gb, L))
            p[f"fc_out2_w_b{j}"] = g((gb, L))
            p[f"fc_out1_g_b{j}"] = ones(L)
            p[f"fc_out2_g_b{j}"] = ones(L)
            p[f"fc_out_b_b{j}"] = zeros(L)
            p[f"bunch_exc_emb_b{j}"] = g((L, L))
            p[f"bunch_pred_emb_b{j}"] = g((L, L))
        p.update({
            "emb_sig": g((L, ed)),
            "emb_pred": g((L, ed)),
            "emb_exc": g((L, ed)),
            "conv1_w": g((CONV_WIDTH * NB_FEATURES, cd)),
            "conv1_b": zeros(cd),
            "conv2_w": g((CONV_WIDTH * cd, cd)),
            "conv2_b": zeros(cd),
            "fc1_w": g((cd, cd)),
            "fc1_b": zeros(cd),
            "fc2_w": g((cd, cd)),
            "fc2_b": zeros(cd),
            "gru_a_wx": g(((2 * S + 1) * ed + cd, 3 * ga)),
            "gru_a_wh": g((ga, 3 * ga)),
            "gru_a_bx": zeros(3 * ga),
            "gru_a_bh": zeros(3 * ga),
            "gru_b_wx": g((ga + cd, 3 * gb)),
            "gru_b_wh": g((gb, 3 * gb)),
            "gru_b_bx": zeros(3 * gb),
            "gru_b_bh": zeros(3 * gb),
            "fc_out1_w": g((gb, L)),
            "fc_out2_w": g((gb, L)),
            "fc_out1_g": ones(L),
            "fc_out2_g": ones(L),
            "fc_out_b": zeros(L),
            # All ones = dense; the trainer prunes it (VocoderTrainer.sparsify).
            "gru_a_mask": torch.ones((ga, 3 * ga), device=dev),
        })
        return p

    # -- frame-rate network --------------------------------------------
    def condition(self, params: Params, features: torch.Tensor
                  ) -> torch.Tensor:
        """features [B, T, 20] (callers prepend FEAT_CONTEXT frames for
        streaming) -> cond [B, T, cond_dim].

        Native checkpoints see the 20 features through causal convs.  An
        imported xiph-LPCNet checkpoint carries an ``emb_pitch`` table: its
        frame network sees concat(features, embed_pitch(period)) through
        same-padded convs."""
        B, T, _ = features.shape
        same_pad = "emb_pitch" in params
        x = features
        if same_pad:
            period = torch.clamp(torch.round(50.0 * x[..., 18] + 100.0),
                                 0, MULAW_LEVELS - 1).long()
            x = torch.cat([x, params["emb_pitch"][period]], dim=-1)
        left = (CONV_WIDTH - 1) // 2 if same_pad else CONV_WIDTH - 1

        def conv3(x, w, b):
            xp = torch.cat([x.new_zeros((B, left, x.shape[2])), x,
                            x.new_zeros((B, CONV_WIDTH - 1 - left,
                                         x.shape[2]))], dim=1)
            stacked = torch.cat([xp[:, i:i + T] for i in range(CONV_WIDTH)],
                                dim=-1)
            return torch.tanh(stacked @ w + b)

        h = conv3(x, params["conv1_w"], params["conv1_b"])
        h = conv3(h, params["conv2_w"], params["conv2_b"])
        h = torch.tanh(h @ params["fc1_w"] + params["fc1_b"])
        return torch.tanh(h @ params["fc2_w"] + params["fc2_b"])

    # -- sample-rate network, one step -----------------------------------
    @staticmethod
    def _gru(x, h, wx, wh, bx, bh, mask=None):
        gx = x @ wx + bx
        gh = h @ (wh if mask is None else wh * mask) + bh
        H = h.shape[-1]
        r = torch.sigmoid(gx[..., :H] + gh[..., :H])
        z = torch.sigmoid(gx[..., H:2 * H] + gh[..., H:2 * H])
        n = torch.tanh(gx[..., 2 * H:] + r * gh[..., 2 * H:])
        return (1.0 - z) * n + z * h

    def sample_logits(self, params: Params, h_b: torch.Tensor) -> torch.Tensor:
        """Dual tanh heads; the optional ``fc_out{1,2}_b`` biases sit inside
        the tanh (xiph's MDense head)."""
        b1 = params.get("fc_out1_b", 0.0)
        b2 = params.get("fc_out2_b", 0.0)
        t1 = torch.tanh(h_b @ params["fc_out1_w"] + b1) * params["fc_out1_g"]
        t2 = torch.tanh(h_b @ params["fc_out2_w"] + b2) * params["fc_out2_g"]
        return t1 + t2 + params["fc_out_b"]

    def sample_step(self, params: Params, carry, cond, lpc, gumbel,
                    temperature):
        """One step for a batch of streams.  carry (h_a [B,ga], h_b [B,gb],
        sig_mem [B,16], exc_idx [B]); cond [B,cd]; lpc [B,16];
        gumbel [B,256]; temperature [B,1] (negative = greedy).
        Returns (carry, (sample [B], exc_idx [B], logits [B,256]))."""
        h_a, h_b, sig_mem, exc_idx = carry
        pred = -torch.sum(sig_mem * lpc, dim=-1)
        x_a = torch.cat([params["emb_sig"][mulaw_encode(sig_mem[:, 0])],
                         params["emb_pred"][mulaw_encode(pred)],
                         params["emb_exc"][exc_idx.long()], cond], dim=-1)
        h_a = self._gru(x_a, h_a, params["gru_a_wx"], params["gru_a_wh"],
                        params["gru_a_bx"], params["gru_a_bh"],
                        params.get("gru_a_mask"))
        x_b = torch.cat([h_a, cond], dim=-1)
        h_b = self._gru(x_b, h_b, params["gru_b_wx"], params["gru_b_wh"],
                        params["gru_b_bx"], params["gru_b_bh"])
        logits = self.sample_logits(params, h_b)
        scores = torch.where(temperature < 0.0, logits,
                             logits * temperature + gumbel)
        new_exc = torch.argmax(scores, dim=-1)
        sample = (pred + mulaw_decode(new_exc)).clamp(-1.0, 1.0)
        sig_mem = torch.cat([sample[:, None], sig_mem[:, :-1]], dim=1)
        return (h_a, h_b, sig_mem, new_exc), (sample, new_exc, logits)

    # -- bunched sample-rate network (S samples per step) ----------------
    def sub_logits(self, params: Params, h_b: torch.Tensor, j: int
                   ) -> torch.Tensor:
        """Dual tanh heads of sub-sample ``j`` of the bunch."""
        if j == 0:
            return self.sample_logits(params, h_b)
        b1 = params.get(f"fc_out1_b_b{j}", 0.0)
        b2 = params.get(f"fc_out2_b_b{j}", 0.0)
        t1 = torch.tanh(h_b @ params[f"fc_out1_w_b{j}"] + b1) \
            * params[f"fc_out1_g_b{j}"]
        t2 = torch.tanh(h_b @ params[f"fc_out2_w_b{j}"] + b2) \
            * params[f"fc_out2_g_b{j}"]
        return t1 + t2 + params[f"fc_out_b_b{j}"]

    def bunch_step(self, params: Params, carry, cond, lpc, gumbel,
                   temperature):
        """One bunched step emitting ``self.bunch`` samples.  carry (h_a
        [B,ga], h_b [B,gb], sig_mem [B,16], exc_hist [B,S], most recent
        first); cond [B,cd]; lpc [B,16]; gumbel [B,S,256]; temperature
        [B,1] (negative = greedy).
        Returns (carry, (samples [B,S], exc [B,S]))."""
        S = self.bunch
        h_a, h_b, sig_mem, exc_hist = carry
        exc_hist = exc_hist.long()
        pred = -torch.sum(sig_mem * lpc, dim=-1)  # of the first sub-sample
        parts = [params["emb_sig"][mulaw_encode(sig_mem[:, 0])]]
        for j in range(1, S):
            parts.append(params[f"emb_sig_l{j}"][mulaw_encode(sig_mem[:, j])])
        parts.append(params["emb_pred"][mulaw_encode(pred)])
        parts.append(params["emb_exc"][exc_hist[:, 0]])
        for j in range(1, S):
            parts.append(params[f"emb_exc_l{j}"][exc_hist[:, j]])
        parts.append(cond)
        h_a = self._gru(torch.cat(parts, dim=-1), h_a, params["gru_a_wx"],
                        params["gru_a_wh"], params["gru_a_bx"],
                        params["gru_a_bh"], params.get("gru_a_mask"))
        h_b = self._gru(torch.cat([h_a, cond], dim=-1), h_b,
                        params["gru_b_wx"], params["gru_b_wh"],
                        params["gru_b_bx"], params["gru_b_bh"])
        samples, excs = [], []
        for j in range(S):
            logits = self.sub_logits(params, h_b, j)
            if j > 0:
                logits = (logits
                          + params[f"bunch_exc_emb_b{j}"][excs[-1]]
                          + params[f"bunch_pred_emb_b{j}"][mulaw_encode(pred)])
            scores = torch.where(temperature < 0.0, logits,
                                 logits * temperature + gumbel[:, j])
            new_exc = torch.argmax(scores, dim=-1)
            sample = (pred + mulaw_decode(new_exc)).clamp(-1.0, 1.0)
            sig_mem = torch.cat([sample[:, None], sig_mem[:, :-1]], dim=1)
            samples.append(sample)
            excs.append(new_exc)
            if j + 1 < S:
                pred = -torch.sum(sig_mem * lpc, dim=-1)
        exc_hist = torch.stack(excs[::-1], dim=1)  # most recent first
        return (h_a, h_b, sig_mem, exc_hist), (torch.stack(samples, dim=1),
                                               torch.stack(excs, dim=1))


def sampler_weights_for(model: LPCNetModel, params: Params) -> Params:
    """The prepared weights of the sampler that ``model`` runs on."""
    if model.bunch > 1:
        return _sampler.prepare_bunched_sampler_weights(params)
    return _sampler.prepare_sampler_weights(params)


class NetVocoderState(NamedTuple):
    h_a: torch.Tensor       # [B, GRU_A]
    h_b: torch.Tensor       # [B, GRU_B]
    sig_mem: torch.Tensor   # [B, LPC_ORDER]
    exc_idx: torch.Tensor   # [B] int64; [B, S], most recent first, at bunch S
    feat_mem: torch.Tensor  # [B, FEAT_CONTEXT, 20] conv left context
    deemph: torch.Tensor    # [B]
    seed: int               # stream seed; noise is keyed by (seed, frame)
    frame_ctr: int          # absolute frame position of the stream
    # The rows' place in the batch the noise is drawn for: row b is slot
    # slot_lo + b of a batch of ``slots`` (0 = these B rows are the whole
    # batch).  A shard of a sharded batch (parallel/shard.py) draws the
    # whole batch's noise for its slots.
    slot_lo: int = 0
    slots: int = 0


def net_vocoder_init(model: LPCNetModel, batch: int, seed: int = 0,
                     device=None) -> NetVocoderState:
    dev = resolve_device(device)
    exc_shape = (batch,) if model.bunch == 1 else (batch, model.bunch)
    return NetVocoderState(
        h_a=torch.zeros((batch, model.gru_a_units), device=dev),
        h_b=torch.zeros((batch, model.gru_b_units), device=dev),
        sig_mem=torch.zeros((batch, LPC_ORDER), device=dev),
        exc_idx=torch.full(exc_shape, MULAW_LEVELS // 2, dtype=torch.long,
                           device=dev),
        feat_mem=torch.zeros((batch, FEAT_CONTEXT, NB_FEATURES), device=dev),
        deemph=torch.zeros((batch,), device=dev),
        seed=int(seed), frame_ctr=0)


_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for uint32 values held in int64, without
    overflowing int64: split h into 16-bit halves."""
    lo, hi = h & 0xFFFF, h >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection with full avalanche)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(seed: int, first_frame: int, frames: int, batch: int,
                 device, slot_lo: int = 0, slots: int = 0) -> torch.Tensor:
    """Capped Gumbel noise [frames, FRAME_SIZE, batch, 256] for absolute
    frames ``first_frame ..``: a counter-based hash of (seed, absolute
    frame, position in the frame), so the noise of a frame never depends
    on how calls chunk the stream, and CPU and CUDA draw the same bits.

    The position counts over a batch of ``slots`` streams (0 = ``batch``),
    of which these are slots ``slot_lo ..``: a shard of a batch draws
    exactly its rows of the whole batch's noise."""
    slots = slots or batch
    if not 0 <= slot_lo <= slots - batch:
        raise ValueError(f"slots {slot_lo}..{slot_lo + batch - 1} lie "
                         f"outside a batch of {slots}")
    f = torch.arange(first_frame, first_frame + frames, dtype=torch.long,
                     device=device) & _M32
    key = _fmix32(_fmix32(f) ^ (int(seed) & _M32))             # [frames]
    pos = torch.arange(FRAME_SIZE, dtype=torch.long, device=device)
    slot = torch.arange(slot_lo, slot_lo + batch, dtype=torch.long,
                        device=device)
    level = torch.arange(MULAW_LEVELS, dtype=torch.long, device=device)
    j = ((pos[:, None, None] * slots + slot[None, :, None]) * MULAW_LEVELS
         + level).reshape(-1)
    bits = _fmix32(key[:, None] ^ j[None, :])                  # [frames, n]
    u = (bits >> 8).float() * (1.0 / (1 << 24)) + 1e-9
    g = torch.clamp(-torch.log(-torch.log(u)), max=NOISE_CAP)
    return g.reshape(frames, FRAME_SIZE, batch, MULAW_LEVELS)


@torch.no_grad()
def net_synthesize_frames(model: LPCNetModel, params: Params,
                          state: NetVocoderState, features: torch.Tensor,
                          temperature_scale: float = 1.0,
                          greedy: bool = False, quiet_sharpen: bool = False,
                          gumbel: Optional[torch.Tensor] = None,
                          sampler_weights: Optional[Params] = None):
    """features [B, T, 20] -> (pcm [B, T*160] in [-1, 1], new state).

    Synthesis runs in 50-frame blocks (a last shorter block takes any
    remainder); each block computes its conditioning, LPC, temperatures,
    noise, samples and de-emphasis at block shape, so splitting a stream
    across calls of whole blocks gives the same audio as one call.  An
    imported same-padded checkpoint (``emb_pitch``) conditions on future
    frames, so it runs the whole call as one block and offers no chunk
    invariance.

    ``greedy`` picks the argmax per sample.  ``gumbel`` [T, 160, B, 256],
    by position in the frame whatever the bunch, replaces the port's own
    noise (tests inject the JAX package's noise); ``sampler_weights`` is
    ``sampler_weights_for(model, params)``, computed here when not given."""
    B, T, _ = features.shape
    with tracing.span("vocoder.synth", streams=B, frames=T):
        w = sampler_weights if sampler_weights is not None \
            else sampler_weights_for(model, params)
        run_sampler = _sampler.sampler_frames_bunched if model.bunch > 1 \
            else _sampler.sampler_frames
        block = T if "emb_pitch" in params else COND_BLOCK
        feats_ctx_all = torch.cat([state.feat_mem, features], dim=1)
        carry = (state.h_a, state.h_b, state.sig_mem, state.exc_idx)
        deemph = state.deemph
        pcm = torch.empty((B, T * FRAME_SIZE), device=features.device)
        for s in range(0, T, block):
            L = min(block, T - s)
            feats_ctx = feats_ctx_all[:, s:s + FEAT_CONTEXT + L]
            feats = feats_ctx[:, FEAT_CONTEXT:]
            with tracing.span("vocoder.condition"):
                cond = model.condition(params, feats_ctx)[:, FEAT_CONTEXT:]
            with tracing.span("vocoder.lpc"):
                lpc = _cepstrum_lpc.lpc_frames(feats)
            if greedy:
                temp = torch.full((B, L), -1.0, device=features.device)
                noise = None
            else:
                corr = torch.clamp(feats[..., NB_BANDS + 1] + 0.5, 0.0, 1.0)
                temp = (1.0 + 1.5 * corr) * temperature_scale
                if quiet_sharpen:
                    quiet = torch.clamp(
                        (QUIET_C0 - feats[..., 0]) * QUIET_GAIN, min=0.0)
                    temp = temp * (1.0 + quiet)
                with tracing.span("vocoder.noise"):
                    noise = (torch.clamp(gumbel[s:s + L], max=NOISE_CAP)
                             if gumbel is not None else
                             gumbel_noise(state.seed, state.frame_ctr + s, L,
                                          B, features.device, state.slot_lo,
                                          state.slots))
            with tracing.span("vocoder.sampler"):
                carry, sig = run_sampler(
                    w, carry, cond.transpose(0, 1).contiguous(), lpc,
                    temp.transpose(0, 1).contiguous(), noise, FRAME_SIZE)
            with tracing.span("vocoder.deemph"):
                y = pcm[:, s * FRAME_SIZE:(s + L) * FRAME_SIZE]
                deemph = _deemphasis.deemphasis(sig, deemph, y)
                y.clamp_(-1.0, 1.0)
    h_a, h_b, sig_mem, exc_idx = carry
    return pcm, NetVocoderState(
        h_a=h_a, h_b=h_b, sig_mem=sig_mem, exc_idx=exc_idx,
        feat_mem=feats_ctx_all[:, -FEAT_CONTEXT:], deemph=deemph,
        seed=state.seed, frame_ctr=state.frame_ctr + T,
        slot_lo=state.slot_lo, slots=state.slots)
