"""Neural autoregressive LPCNet vocoder, bunch 1 (counterpart of
dss_tpu/vocoder/net.py).

* frame-rate network: two causal 3-tap convs + two dense layers (tanh)
  mapping the 20 features to a 128-dim conditioning vector per frame;
* sample-rate network per 16 kHz sample: mu-law embeddings of (last
  sample, LPC prediction, last excitation), GRU-A (reset-after, masked
  recurrent matrix), GRU-B, dual tanh heads over 256 mu-law levels, and
  Gumbel-max sampling; the excitation plus the LPC prediction is the next
  sample.

Parameters stay a dict of tensors in the JAX package's layouts ([in, out]
matrices), so checkpoints and the tests carry over unchanged.  The sample
loop runs in the sampler kernel (ops/sampler.py) in fixed 50-frame blocks.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import device_constant, resolve_device
from ..ops.sampler import prepare_sampler_weights, sampler_frames
from .lpc import FRAME_SIZE, LPC_ORDER, NB_BANDS, NB_FEATURES, PREEMPH, \
    bands_from_cepstrum, lpc_from_bands
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
    """Hyperparameters + functional network pieces (bunch 1)."""

    def __init__(self, gru_a_units: int = GRU_A_UNITS,
                 gru_b_units: int = GRU_B_UNITS, cond_dim: int = COND_DIM,
                 embed_dim: int = EMBED_DIM):
        self.gru_a_units = gru_a_units
        self.gru_b_units = gru_b_units
        self.cond_dim = cond_dim
        self.embed_dim = embed_dim

    @classmethod
    def from_params(cls, params: Params) -> "LPCNetModel":
        """The architecture from a checkpoint's shapes."""
        if "emb_sig_l1" in params:
            raise NotImplementedError(
                "bunched (b2/b4/b8) checkpoints are not ported yet")
        if "emb_pitch" in params:
            raise NotImplementedError(
                "same-padded imported checkpoints (emb_pitch) are not "
                "ported yet")
        return cls(gru_a_units=params["gru_a_wh"].shape[0],
                   gru_b_units=params["gru_b_wh"].shape[0],
                   cond_dim=params["fc1_w"].shape[0],
                   embed_dim=params["emb_sig"].shape[1])

    # -- frame-rate network --------------------------------------------
    def condition(self, params: Params, features: torch.Tensor
                  ) -> torch.Tensor:
        """features [B, T, 20] (callers prepend FEAT_CONTEXT frames for
        streaming) -> cond [B, T, cond_dim], causal convs."""
        B, T, _ = features.shape

        def conv3(x, w, b):
            pad = x.new_zeros((B, CONV_WIDTH - 1, x.shape[2]))
            xp = torch.cat([pad, x], dim=1)
            stacked = torch.cat([xp[:, i:i + T] for i in range(CONV_WIDTH)],
                                dim=-1)
            return torch.tanh(stacked @ w + b)

        h = conv3(features, params["conv1_w"], params["conv1_b"])
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


class NetVocoderState(NamedTuple):
    h_a: torch.Tensor       # [B, GRU_A]
    h_b: torch.Tensor       # [B, GRU_B]
    sig_mem: torch.Tensor   # [B, LPC_ORDER]
    exc_idx: torch.Tensor   # [B] int64
    feat_mem: torch.Tensor  # [B, FEAT_CONTEXT, 20] conv left context
    deemph: torch.Tensor    # [B]
    seed: int               # stream seed; noise is keyed by (seed, frame)
    frame_ctr: int          # absolute frame position of the stream


def net_vocoder_init(model: LPCNetModel, batch: int, seed: int = 0,
                     device=None) -> NetVocoderState:
    dev = resolve_device(device)
    return NetVocoderState(
        h_a=torch.zeros((batch, model.gru_a_units), device=dev),
        h_b=torch.zeros((batch, model.gru_b_units), device=dev),
        sig_mem=torch.zeros((batch, LPC_ORDER), device=dev),
        exc_idx=torch.full((batch,), MULAW_LEVELS // 2, dtype=torch.long,
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
                 device) -> torch.Tensor:
    """Capped Gumbel noise [frames, FRAME_SIZE, batch, 256] for absolute
    frames ``first_frame ..``: a counter-based hash of (seed, absolute
    frame, position in the frame), so the noise of a frame never depends
    on how calls chunk the stream, and CPU and CUDA draw the same bits."""
    per_frame = FRAME_SIZE * batch * MULAW_LEVELS
    f = torch.arange(first_frame, first_frame + frames, dtype=torch.long,
                     device=device) & _M32
    key = _fmix32(_fmix32(f) ^ (int(seed) & _M32))             # [frames]
    j = torch.arange(per_frame, dtype=torch.long, device=device)
    bits = _fmix32(key[:, None] ^ j[None, :])                  # [frames, n]
    u = (bits >> 8).float() * (1.0 / (1 << 24)) + 1e-9
    g = torch.clamp(-torch.log(-torch.log(u)), max=NOISE_CAP)
    return g.reshape(frames, FRAME_SIZE, batch, MULAW_LEVELS)


def _deemph_constants(L: int):
    """(M^T, a^(k+1), Q^T, A^(j+1)) of ``deemphasis`` for L frames, in
    float64: M [160, 160] with M[k, m] = a^(k-m) for m <= k, and Q [L, L]
    the same over frames with A = a^160."""
    k = np.arange(FRAME_SIZE)
    d = k[:, None] - k[None, :]
    M = np.where(d >= 0, PREEMPH ** np.maximum(d, 0), 0.0)
    A = PREEMPH ** FRAME_SIZE
    j = np.arange(L)
    dj = j[:, None] - j[None, :]
    Q = np.where(dj >= 0, A ** np.maximum(dj, 0), 0.0)
    return M.T, PREEMPH ** (k + 1.0), Q.T, A ** (j + 1.0)


def deemphasis(sig: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """y[t] = sig[t] + PREEMPH * y[t-1] over sig [B, L*FRAME_SIZE] from
    y[-1] = y0 [B], in an exact blocked form: a [160 x 160] lower-triangular
    Toeplitz product inside each frame, then the frame-end carries through
    an [L x L] one — four launches instead of a serial loop.  Equal to the
    sequential recurrence up to float32 rounding (~1e-6)."""
    B, N = sig.shape
    L = N // FRAME_SIZE
    M_t, a_k, Q_t, a_j = (
        device_constant(("deemph", L, i), sig.device, sig.dtype,
                        lambda i=i: _deemph_constants(L)[i])
        for i in range(4))
    z = sig.reshape(B, L, FRAME_SIZE) @ M_t          # in-frame responses
    c = z[..., -1] @ Q_t + a_j * y0[:, None]         # y at each frame end
    c_prev = torch.cat([y0[:, None], c[:, :-1]], dim=1)
    return (z + c_prev[..., None] * a_k).reshape(B, N)


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
    across calls of whole blocks gives the same audio as one call.

    ``greedy`` picks the argmax per sample.  ``gumbel`` [T, 160, B, 256]
    replaces the port's own noise (tests inject the JAX package's noise);
    ``sampler_weights`` is ``prepare_sampler_weights(params)``, computed
    here when not given."""
    B, T, _ = features.shape
    w = sampler_weights if sampler_weights is not None \
        else prepare_sampler_weights(params)
    feats_ctx_all = torch.cat([state.feat_mem, features], dim=1)
    carry = (state.h_a, state.h_b, state.sig_mem, state.exc_idx)
    deemph = state.deemph
    parts = []
    for s in range(0, T, COND_BLOCK):
        L = min(COND_BLOCK, T - s)
        feats_ctx = feats_ctx_all[:, s:s + FEAT_CONTEXT + L]
        feats = feats_ctx[:, FEAT_CONTEXT:]
        cond = model.condition(params, feats_ctx)[:, FEAT_CONTEXT:]
        lpc, _ = lpc_from_bands(bands_from_cepstrum(feats[..., :NB_BANDS]))
        if greedy:
            temp = torch.full((B, L), -1.0, device=features.device)
            noise = None
        else:
            corr = torch.clamp(feats[..., NB_BANDS + 1] + 0.5, 0.0, 1.0)
            temp = (1.0 + 1.5 * corr) * temperature_scale
            if quiet_sharpen:
                quiet = torch.clamp((QUIET_C0 - feats[..., 0]) * QUIET_GAIN,
                                    min=0.0)
                temp = temp * (1.0 + quiet)
            noise = (torch.clamp(gumbel[s:s + L], max=NOISE_CAP)
                     if gumbel is not None else
                     gumbel_noise(state.seed, state.frame_ctr + s, L, B,
                                  features.device))
        carry, sig = sampler_frames(
            w, carry, cond.transpose(0, 1).contiguous(),
            lpc.transpose(0, 1).contiguous(),
            temp.transpose(0, 1).contiguous(), noise, FRAME_SIZE)
        y = deemphasis(sig, deemph)
        deemph = y[:, -1]
        parts.append(torch.clamp(y, -1.0, 1.0))
    pcm = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    h_a, h_b, sig_mem, exc_idx = carry
    return pcm, NetVocoderState(
        h_a=h_a, h_b=h_b, sig_mem=sig_mem, exc_idx=exc_idx,
        feat_mem=feats_ctx_all[:, -FEAT_CONTEXT:], deemph=deemph,
        seed=state.seed, frame_ctr=state.frame_ctr + T)
