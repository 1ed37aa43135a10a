"""Neural vocoder trainer (counterpart of dss_tpu/train/trainer_vocoder.py):
teacher-forced mu-law excitation cross-entropy, scheduled sampling, the
free-running STFT fine-tune, and progressive block pruning of GRU-A's
recurrent matrix in the [16 x 128] tiles that the sampler kernel skips.

In PyTorch's idiom: the parameters are a dict of leaf tensors in the JAX
layouts (``vocoder/net.py``'s ``Params``; all but the mask require grad),
gradients come from autograd, and the trainer owns its ``torch.optim.Adam``
(``train/optim.py::torch_adam``).  Every loss that draws takes its noise as
an optional argument (``noise`` [B, S] int64, ``gumbel``) and otherwise
draws from the trainer's ``torch.Generator`` on its device; the tests inject
the JAX package's draws.

Where the time goes on the card:
* the teacher-forced LPC recursion is kernel D2 (``ops/lpc_recursion.py``),
  one launch a batch;
* the teacher-forced GRU scans go to ``torch.gru`` (cuDNN): the JAX cell is
  PyTorch's cell exactly (gates r, z, n; n = tanh(gx_n + r * (h @ wh_n +
  bh_n)); h' = (1 - z) * n + z * h), with the JAX [in, out] weights
  transposed, so the gradient reaches ``gru_a_wh`` through the mask product
  as in JAX;
* the free-running rollouts are an eager autograd loop, one step a sample
  (or a bunch; the GRUs as ``torch.gru_cell``, one fused gate kernel a step
  on the card), and are launch-bound.  The JAX package wraps their step in
  ``jax.checkpoint`` to save memory; the port keeps the activations (a few
  GB at B = 32 x 2400 samples; chip_smoke.py reports the peak).

Divergences from the JAX module: ``_prepare_cond`` returns the conditioning
and the taps per frame (the callers repeat them where they need one per
sample); ``init`` builds the optimizer beside the parameters; ``_apply``
reads the gradient norm's finiteness on the host (one read a step) and
skips ``optimizer.step()`` and the scheduler on a non-finite batch, which
leaves parameters, moments and step count as they were, as the JAX
``where`` does.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import sampler as _sampler
from ..ops.lpc_recursion import Recursion, decode_table, lpc_recursion
from ..vocoder.features import LPCFeatureEncoder
from ..vocoder.lpc import FRAME_SIZE, LPC_ORDER, NB_BANDS, PREEMPH, \
    bands_from_cepstrum, lpc_from_bands
from ..vocoder.mulaw import MULAW_LEVELS, mulaw_encode
from ..vocoder.net import FEAT_CONTEXT, LPCNetModel, Params
from .optim import torch_adam

MASK = "gru_a_mask"


def prepare_utterance(audio: np.ndarray, device=None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """16 kHz PCM -> (features [T, 20], preemphasized float signal [T*160]).

    Trailing partial frames are dropped; the signal is in the vocoder's
    pre-emphasized modeling domain.  The encoder runs on ``device``."""
    audio = np.asarray(audio)
    if np.issubdtype(audio.dtype, np.integer):
        audio = audio.astype(np.float32) / 32768.0
    enc = LPCFeatureEncoder(device=device)
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype(np.int16)
    feats = enc.compute_LPC_features(pcm)
    n = len(feats) * FRAME_SIZE
    sig = audio[:n].astype(np.float32)
    shifted = np.concatenate([[0.0], sig[:-1]]).astype(np.float32)
    return feats, sig - PREEMPH * shifted


def _multi_res_stft_loss(x: torch.Tensor, y: torch.Tensor,
                         fft_sizes=(512, 1024, 256)) -> torch.Tensor:
    """Mean log-magnitude STFT distance over several resolutions.

    Magnitude-only (an AR sampler can never match the target's noise
    phase), log-domain (what the Bark-cepstral quality metric measures),
    mean over frames/bins/resolutions.  x, y: [B, S] in the modeling
    (pre-emphasized) domain.  Chunks shorter than every size take the
    largest power of two that fits."""
    S = int(x.shape[1])
    fft_sizes = [n for n in fft_sizes if n <= S] or [1 << (S.bit_length() - 1)]
    total = 0.0
    for n_fft in fft_sizes:
        hop = n_fft // 4
        # jnp.hanning: the symmetric window.
        win = torch.hann_window(n_fft, periodic=False, dtype=x.dtype,
                                device=x.device)
        fx = torch.fft.rfft(x.unfold(1, n_fft, hop) * win, dim=-1)
        fy = torch.fft.rfft(y.unfold(1, n_fft, hop) * win, dim=-1)
        lx = torch.log(fx.abs() + 1e-5)
        ly = torch.log(fy.abs() + 1e-5)
        total = total + (lx - ly).abs().mean()
    return total / len(fft_sizes)


class VocoderBatch(NamedTuple):
    features: torch.Tensor  # [B, T, 20]
    signal: torch.Tensor    # [B, T*160] pre-emphasized float


def _gru_sequence(x: torch.Tensor, wx, wh, bx, bh) -> torch.Tensor:
    """GRU states over a sequence from a zero state, x [B, N, in] -> [B, N,
    H], through ``torch.gru`` (the op behind ``nn.GRU``: cuDNN on the card)
    with the JAX layouts' weights transposed: wx [in, 3H], wh [H, 3H], gates
    r, z, n in both.  cuDNN copies the weights into its flat buffer each
    call (they are not one ``nn.GRU``'s flattened parameters); that copy is
    part of the step."""
    H = wh.shape[0]
    h0 = x.new_zeros((1, x.shape[0], H))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*contiguous chunk of memory")
        out, _ = torch.gru(x, h0, [wx.t().contiguous(), wh.t().contiguous(),
                                   bx, bh], True, 1, 0.0, True, False, True)
    return out


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))


class VocoderTrainer:
    """Owns the parameters (after ``init``), their Adam optimizer and
    optional LR schedule, and a random generator on ``device`` (the card
    unless the caller asks for another) seeded with ``seed``."""

    def __init__(self, model: LPCNetModel, learning_rate: float = 1e-3,
                 noise_level: int = 2, lr_decay: float = 0.0,
                 drift_bound: int = 24, stft_weight: float = 2.0,
                 grad_clip: float = 0.0, rollout_detach: int = 0,
                 device=None, seed: int = 0):
        self.model = model
        self.device = resolve_device(device)
        self.learning_rate = learning_rate
        self.lr_decay = lr_decay
        # mu-law domain jitter on the signal history (LPCNet's input noise).
        self.noise_level = noise_level
        # Scheduled sampling: max |fed-back - correcting| excitation
        # deviation in mu-law levels (unbounded drift degenerates: histories
        # rail at +-1 and the clipped targets become trivially predictable).
        self.drift_bound = drift_bound
        # Weight of the STFT term in the free-running fine-tune loss.
        self.stft_weight = stft_weight
        # Global-norm gradient clip (0 = off): the rollout backpropagates
        # through a resonant LPC synthesis filter.
        self.grad_clip = grad_clip
        # Truncate rollout backprop every N samples (0 = full length).
        self.rollout_detach = rollout_detach
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.params: Optional[Params] = None
        self.trainable: List[str] = []
        self.optimizer = None
        self.scheduler = None

    # -- parameters and optimizer -----------------------------------------
    def init(self, params=None) -> Params:
        """Fresh parameters drawn from the trainer's generator, or copies of
        ``params`` (a dict of arrays or tensors, e.g. a checkpoint) on the
        trainer's device; builds a fresh optimizer over them.  Returns the
        parameter dict (also ``self.params``)."""
        if params is None:
            params = self.model.init(self.generator, self.device)
        else:
            params = {k: torch.as_tensor(np.asarray(v) if not isinstance(
                v, torch.Tensor) else v.detach(), dtype=torch.float32).to(
                    self.device, copy=True) for k, v in params.items()}
        self.trainable = [k for k in params if k != MASK]
        for k in self.trainable:
            params[k].requires_grad_(True)
        self.params = params
        self.optimizer, self.scheduler = torch_adam(
            [params[k] for k in self.trainable], self.learning_rate,
            self.lr_decay)
        return params

    def load_optimizer_state(self, state: Dict[int, Dict[str, torch.Tensor]],
                             step: int) -> None:
        """Resume the optimizer from ``state`` (the ``state`` entry of its
        state_dict, e.g. from ``convert.adam_state``) after ``step`` applied
        updates: the learning-rate schedule continues from there."""
        sd = self.optimizer.state_dict()
        sd["state"] = state
        self.optimizer.load_state_dict(sd)
        if self.scheduler is not None:
            self.scheduler.last_epoch = step
            for g, lam, base in zip(self.optimizer.param_groups,
                                    self.scheduler.lr_lambdas,
                                    self.scheduler.base_lrs):
                g["lr"] = base * lam(step)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def _draw_noise(self, B: int, S: int) -> torch.Tensor:
        return torch.randint(-self.noise_level, self.noise_level + 1, (B, S),
                             generator=self.generator, device=self.device)

    def _draw_gumbel(self, shape) -> torch.Tensor:
        """Standard Gumbel draws, -log(-log(u)) with u in [tiny, 1)."""
        u = torch.rand(shape, generator=self.generator, device=self.device)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    # -- shared pieces ---------------------------------------------------
    def _prepare_cond(self, params: Params, features: torch.Tensor):
        """-> (cond [B,T,cd], lpc [B,T,16], corr [B,T]) per frame, shared by
        all loss variants (the JAX function returns cond and lpc repeated to
        one row a sample)."""
        B, T, nf = features.shape
        feats_ctx = torch.cat([features.new_zeros((B, FEAT_CONTEXT, nf)),
                               features], dim=1)
        cond = self.model.condition(params, feats_ctx)[:, FEAT_CONTEXT:]
        lpc, _ = lpc_from_bands(bands_from_cepstrum(features[..., :NB_BANDS]))
        corr = torch.clamp(features[..., NB_BANDS + 1] + 0.5, 0.0, 1.0)
        return cond, lpc, corr

    def _recursion(self, signal: torch.Tensor, lpc: torch.Tensor,
                   noise: Optional[torch.Tensor] = None,
                   feedback: Optional[torch.Tensor] = None) -> Recursion:
        """The LPC synthesis recurrence with an imperfect fed-back
        excitation, exactly as the sampler feeds back its own samples (next
        history sample = clip(pred + decoded e)), through kernel D2.

        Exactly one of ``noise`` [B,S] (mu-law jitter added to each step's
        correcting excitation) or ``feedback`` [B,S] (the fed-back
        excitation, clamped to ``drift_bound`` around the correcting one);
        neither means no jitter.  lpc is per frame [B,T,16].
        -> (pred, exc_tgt, exc_fb, sig_rec), all [B,S]."""
        if feedback is not None:
            return lpc_recursion(signal, lpc, feedback.long(), feedback=True,
                                 drift_bound=self.drift_bound)
        return lpc_recursion(signal, lpc,
                             None if noise is None else noise.long())

    def _forward_ce(self, params: Params, cond_up: torch.Tensor,
                    pred: torch.Tensor, exc_idx: torch.Tensor,
                    exc_noisy: torch.Tensor, sig_rec: torch.Tensor,
                    return_logits: bool = False) -> torch.Tensor:
        """Sample-rate network forward on (possibly drifted) teacher inputs.

        exc_idx is the CE target; exc_noisy/sig_rec are the fed-back
        excitation and reconstruction actually seen as inputs.  With
        ``return_logits`` (bunch=1 only) returns [B,S,256] logits instead
        of the scalar CE."""
        B, S = pred.shape
        L = MULAW_LEVELS
        prev_exc = torch.cat([exc_noisy.new_full((B, 1), L // 2),
                              exc_noisy[:, :-1]], dim=1)
        prev_sig_idx = mulaw_encode(F.pad(sig_rec, (1, 0))[:, :S])
        pred_idx = mulaw_encode(pred)

        # At bunch=K the recurrence runs at 16 kHz / K: GRU inputs are
        # gathered at bunch starts (teacher-forced lags of the previous K
        # samples/excitations) and each sub-sample j gets its own head.
        K = self.model.bunch
        if return_logits and K > 1:
            raise ValueError("return_logits is a bunch=1 (per-sample head) "
                             "facility")
        if K > 1:
            parts = [params["emb_sig"][prev_sig_idx[:, ::K]]]
            for j in range(1, K):
                # lag j at bunch start t: noisy reconstruction s_rec[t-1-j].
                lag_idx = mulaw_encode(F.pad(sig_rec, (j + 1, 0))[:, :S:K])
                parts.append(params[f"emb_sig_l{j}"][lag_idx])
            parts.append(params["emb_pred"][pred_idx[:, ::K]])
            parts.append(params["emb_exc"][prev_exc[:, ::K]])
            for j in range(1, K):
                lag_exc = torch.cat([exc_noisy.new_full((B, j + 1), L // 2),
                                     exc_noisy], dim=1)[:, :S:K]
                parts.append(params[f"emb_exc_l{j}"][lag_exc])
            cond_up = cond_up[:, ::K]
            parts.append(cond_up)
        else:
            parts = [params["emb_sig"][prev_sig_idx],
                     params["emb_pred"][pred_idx],
                     params["emb_exc"][prev_exc], cond_up]
        x_a = torch.cat(parts, dim=-1)
        h_a = _gru_sequence(x_a, params["gru_a_wx"],
                            params["gru_a_wh"] * params[MASK],
                            params["gru_a_bx"], params["gru_a_bh"])
        x_b = torch.cat([h_a, cond_up], dim=-1)
        h_b = _gru_sequence(x_b, params["gru_b_wx"],
                            params["gru_b_wh"], params["gru_b_bx"],
                            params["gru_b_bh"])

        if K > 1:
            ces = []
            for j in range(K):
                logits = self.model.sub_logits(params, h_b, j)
                if j > 0:
                    # Condition on the (noisy) fed-back excitation, as the
                    # sampler will at inference; the target stays clean.
                    logits = (logits
                              + params[f"bunch_exc_emb_b{j}"][
                                  exc_noisy[:, j - 1::K]]
                              + params[f"bunch_pred_emb_b{j}"][
                                  pred_idx[:, j::K]])
                logp = F.log_softmax(logits, dim=-1)
                ces.append(-logp.gather(-1, exc_idx[:, j::K, None])[..., 0])
            return torch.stack(ces).mean()

        logits = self.model.sample_logits(params, h_b)               # [B,S,256]
        if return_logits:
            return logits
        logp = F.log_softmax(logits, dim=-1)
        return -logp.gather(-1, exc_idx[..., None]).mean()

    # -- the three losses ------------------------------------------------
    def _loss(self, params: Params, features: torch.Tensor,
              signal: torch.Tensor, noise: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """Teacher-forced CE over all samples of the batch (uniform
        mu-law-domain noise propagated through the AR recurrence; ``noise``
        [B,S] injects it, else it is drawn when noise_level > 0)."""
        B, T, _ = features.shape
        cond, lpc, _corr = self._prepare_cond(params, features)
        if noise is None and self.noise_level > 0:
            noise = self._draw_noise(B, T * FRAME_SIZE)
        rec = self._recursion(signal, lpc, noise=noise)
        return self._forward_ce(params, cond.repeat_interleave(FRAME_SIZE, 1),
                                *rec)

    def _loss_sampled(self, params: Params, features: torch.Tensor,
                      signal: torch.Tensor,
                      gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scheduled-sampling CE (bunch=1): drift the teacher-forced history
        with the model's OWN sampled excitations instead of uniform noise.

        Pass 1 computes clean teacher-forced logits and samples one
        excitation per step with the inference temperature (1 + 1.5*corr;
        the draw itself carries no gradient; ``gumbel`` [B,S,256] injects
        its noise), and pass 2 trains the model to emit the correcting
        excitation given the so-drifted history.  The loss is the MEAN of
        the clean pass-1 CE (the anchor) and the drifted pass-2 CE."""
        if self.model.bunch != 1:
            raise ValueError("scheduled sampling is implemented for bunch=1; "
                             "use the uniform-noise loss for bunched models")
        cond, lpc, corr = self._prepare_cond(params, features)
        cond_up = cond.repeat_interleave(FRAME_SIZE, 1)

        rec0 = self._recursion(signal, lpc)
        logits0 = self._forward_ce(params, cond_up, *rec0, return_logits=True)
        logp0 = F.log_softmax(logits0, dim=-1)
        ce_clean = -logp0.gather(-1, rec0.exc_tgt[..., None]).mean()
        temp = (1.0 + 1.5 * corr).repeat_interleave(FRAME_SIZE, 1)[..., None]
        frozen = logits0.detach()
        if gumbel is None:
            gumbel = self._draw_gumbel(frozen.shape)
        e_samp = torch.argmax(frozen * temp + gumbel, dim=-1)        # [B,S]

        rec = self._recursion(signal, lpc, feedback=e_samp)
        ce_drift = self._forward_ce(params, cond_up, *rec)
        return 0.5 * (ce_clean + ce_drift)

    def _detach_steps(self, n_steps: int, period: int) -> set:
        if period <= 0:
            return set()
        return set(range(period, n_steps, period))

    def _loss_freerun(self, params: Params, features: torch.Tensor,
                      signal: torch.Tensor,
                      gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Free-running fine-tune loss: synthesize the chunk the way
        inference does (the model's own sampled excitation fed back through
        the LPC recurrence AND the GRU state) and penalize the spectral
        divergence of the rollout from the true signal; the clean
        teacher-forced CE rides along as an anchor.

        The sampled excitation is a straight-through estimator (forward: the
        hard draw; backward: the softmax-expected decoded excitation).
        ``gumbel`` is [S,B,256] at bunch 1, [S/K,B,K,256] at bunch K (as the
        JAX draws).  Bunched models roll out with ``bunch_step`` semantics
        (``_rollout_bunched``)."""
        cond, lpc, corr = self._prepare_cond(params, features)
        if self.model.bunch > 1:
            sig_rec = self._rollout_bunched(params, features, signal, gumbel,
                                            prepared=(cond, lpc, corr))
        else:
            sig_rec = self._rollout(params, cond, lpc, corr, gumbel)
        stft = _multi_res_stft_loss(sig_rec, signal)
        # Clean teacher-forced CE anchor (same weights, true history).
        rec0 = self._recursion(signal, lpc)
        ce = self._forward_ce(params, cond.repeat_interleave(FRAME_SIZE, 1),
                              *rec0)
        return ce + self.stft_weight * stft

    @staticmethod
    def _gru_cells(params: Params):
        """GRU-A (masked) and GRU-B steps for the rollouts: ``torch.gru_cell``
        (one fused kernel for the gates on the card; the cell of
        ``LPCNetModel._gru``) with the JAX layouts' weights transposed, the
        mask product taken once a rollout."""
        wa = (params["gru_a_wx"].t(), (params["gru_a_wh"] * params[MASK]).t(),
              params["gru_a_bx"], params["gru_a_bh"])
        wb = (params["gru_b_wx"].t(), params["gru_b_wh"].t(),
              params["gru_b_bx"], params["gru_b_bh"])
        return (lambda x, h: torch.gru_cell(x, h, *wa),
                lambda x, h: torch.gru_cell(x, h, *wb))

    def _rollout(self, params: Params, cond, lpc, corr, gumbel=None
                 ) -> torch.Tensor:
        """Free-running synthesis of the chunk at bunch 1, one eager step a
        sample: the GRUs consume hard indices (exactly inference); the
        waveform path consumes the straight-through excitation.  Returns
        the reconstruction [B, S]."""
        model = self.model
        B, T = corr.shape
        S = T * FRAME_SIZE
        L = MULAW_LEVELS
        table = decode_table(cond.device)
        if gumbel is None:
            gumbel = self._draw_gumbel((S, B, L))
        cond_f, lpc_f = cond.unbind(1), lpc.unbind(1)
        temp_f = (1.0 + 1.5 * corr)[..., None].unbind(1)
        gru_a, gru_b = self._gru_cells(params)
        detach = self._detach_steps(S, self.rollout_detach)
        h_a = cond.new_zeros((B, model.gru_a_units))
        h_b = cond.new_zeros((B, model.gru_b_units))
        hist = cond.new_zeros((B, LPC_ORDER))
        exc_prev = torch.full((B,), L // 2, dtype=torch.long,
                              device=cond.device)
        samples = []
        for t in range(S):
            f = t // FRAME_SIZE
            if t in detach:
                # Truncated rollout backprop: windowed gradient paths,
                # full-length forward drift.
                h_a, h_b, hist = h_a.detach(), h_b.detach(), hist.detach()
            cond_t, temp_t = cond_f[f], temp_f[f]
            pred = -torch.sum(hist * lpc_f[f], dim=-1)
            # The last sample's and the prediction's levels in one encode.
            idx = mulaw_encode(torch.stack([hist[:, 0], pred]).detach())
            x_a = torch.cat([params["emb_sig"][idx[0]],
                             params["emb_pred"][idx[1]],
                             params["emb_exc"][exc_prev], cond_t], dim=-1)
            h_a = gru_a(x_a, h_a)
            h_b = gru_b(torch.cat([h_a, cond_t], dim=-1), h_b)
            scaled = model.sample_logits(params, h_b) * temp_t
            exc_hard = torch.argmax(scaled + gumbel[t], dim=-1)
            e_soft = torch.softmax(scaled, dim=-1) @ table
            e = e_soft + (table[exc_hard] - e_soft).detach()
            sample = torch.clamp(pred + e, -1.0, 1.0)
            hist = torch.cat([sample[:, None], hist[:, :-1]], dim=1)
            exc_prev = exc_hard
            samples.append(sample)
        return torch.stack(samples, dim=1)

    def _rollout_bunched(self, params: Params, features: torch.Tensor,
                         signal: torch.Tensor,
                         gumbel: Optional[torch.Tensor] = None,
                         prepared=None) -> torch.Tensor:
        """Free-running synthesis of the chunk for a bunch=K model,
        differentiable via straight-through sub-sample draws, mirroring
        ``LPCNetModel.bunch_step`` operation for operation: per GRU advance
        the input gathers the previous K samples/excitations from the
        drifted history through the per-lag tables, and sub-sample j>=1's
        head is shifted by the previous draw's correction embedding.
        ``gumbel`` [S/K, B, K, 256].  Returns the reconstruction [B, S]."""
        model = self.model
        K = model.bunch
        cond, lpc, corr = prepared if prepared is not None else \
            self._prepare_cond(params, features)
        B, T = corr.shape
        S = T * FRAME_SIZE
        n_steps = S // K
        L = MULAW_LEVELS
        table = decode_table(cond.device)
        if gumbel is None:
            gumbel = self._draw_gumbel((n_steps, B, K, L))
        cond_f, lpc_f = cond.unbind(1), lpc.unbind(1)
        temp_f = (1.0 + 1.5 * corr)[..., None].unbind(1)
        gru_a, gru_b = self._gru_cells(params)
        detach = self._detach_steps(n_steps, max(1, self.rollout_detach // K)
                                    if self.rollout_detach > 0 else 0)
        h_a = cond.new_zeros((B, model.gru_a_units))
        h_b = cond.new_zeros((B, model.gru_b_units))
        hist = cond.new_zeros((B, LPC_ORDER))
        exc_hist = torch.full((B, K), L // 2, dtype=torch.long,
                              device=cond.device)
        steps = []
        for n in range(n_steps):
            f = (n * K) // FRAME_SIZE
            if n in detach:
                h_a, h_b, hist = h_a.detach(), h_b.detach(), hist.detach()
            cond_t, lpc_t, temp_t = cond_f[f], lpc_f[f], temp_f[f]
            pred = -torch.sum(hist * lpc_t, dim=-1)
            # The last K samples' and the prediction's levels in one encode.
            idx = mulaw_encode(torch.cat([hist[:, :K], pred[:, None]],
                                         dim=1).detach())
            parts = [params["emb_sig"][idx[:, 0]]]
            for j in range(1, K):
                parts.append(params[f"emb_sig_l{j}"][idx[:, j]])
            parts.append(params["emb_pred"][idx[:, K]])
            parts.append(params["emb_exc"][exc_hist[:, 0]])
            for j in range(1, K):
                parts.append(params[f"emb_exc_l{j}"][exc_hist[:, j]])
            parts.append(cond_t)
            h_a = gru_a(torch.cat(parts, dim=-1), h_a)
            h_b = gru_b(torch.cat([h_a, cond_t], dim=-1), h_b)
            samples, excs = [], []
            for j in range(K):
                logits = model.sub_logits(params, h_b, j)
                if j > 0:
                    logits = (logits
                              + params[f"bunch_exc_emb_b{j}"][excs[-1]]
                              + params[f"bunch_pred_emb_b{j}"][
                                  mulaw_encode(pred.detach())])
                scaled = logits * temp_t
                exc_hard = torch.argmax(scaled + gumbel[n, :, j], dim=-1)
                e_soft = torch.softmax(scaled, dim=-1) @ table
                e = e_soft + (table[exc_hard] - e_soft).detach()
                sample = torch.clamp(pred + e, -1.0, 1.0)
                hist = torch.cat([sample[:, None], hist[:, :-1]], dim=1)
                samples.append(sample)
                excs.append(exc_hard)
                if j + 1 < K:
                    pred = -torch.sum(hist * lpc_t, dim=-1)
            exc_hist = torch.stack(excs[::-1], dim=1)    # most recent first
            steps.append(torch.stack(samples, dim=1))
        return torch.stack(steps, dim=1).reshape(B, S)

    # -- updates ---------------------------------------------------------
    def _step(self, loss_fn, features, signal, draw) -> torch.Tensor:
        params = self.params
        loss = loss_fn(params, self._tensor(features), self._tensor(signal),
                       draw)
        leaves = [params[k] for k in self.trainable]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        self._apply({k: g if g is not None else torch.zeros_like(p)
                     for k, p, g in zip(self.trainable, leaves, grads)})
        return loss.detach()

    def train_step(self, features, signal,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One teacher-forced update; returns the loss before it (a device
        scalar, reported as-is when the batch was skipped)."""
        return self._step(self._loss, features, signal, noise)

    def train_step_sampled(self, features, signal,
                           gumbel: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """train_step with the scheduled-sampling loss (bunch=1)."""
        return self._step(self._loss_sampled, features, signal, gumbel)

    def train_step_freerun(self, features, signal,
                           gumbel: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """train_step with the free-running STFT + CE-anchor loss."""
        return self._step(self._loss_freerun, features, signal, gumbel)

    def _apply(self, grads: Dict[str, torch.Tensor]) -> bool:
        """One optimizer update from ``grads`` (name -> gradient of each
        trainable parameter).  A batch whose gradient norm is not finite is
        skipped outright: clipping by scale is no safety net (inf * 0 =
        NaN poisons every weight in one step), so neither the optimizer nor
        the schedule steps, and parameters, moments and step count stay as
        they were.  Pruned blocks are re-zeroed after every update (Adam's
        leftover moments move them even at zero gradient).  Returns whether
        the update was applied."""
        gs = [grads[k] for k in self.trainable]
        gnorm = global_norm(gs)
        if not bool(torch.isfinite(gnorm)):
            return False
        if self.grad_clip > 0.0:
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            gs = [g * scale for g in gs]
        for k, g in zip(self.trainable, gs):
            self.params[k].grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.scheduler is not None:
            self.scheduler.step()
        with torch.no_grad():
            self.params["gru_a_wh"].mul_(self.params[MASK])
        return True

    def sparsify(self, params: Params, density: float, block=None) -> Params:
        """Magnitude-prune GRU-A recurrent weights to ``density``: updates
        the mask and zeroes the pruned weights of ``params`` in place, and
        returns it.

        Default block granularity is the sampler kernel's [16, 128] tile
        (ops/sampler.py ROW_BLOCK x COL_BLOCK), so that every pruned block
        is a whole tile the kernel skips; models too small for whole tiles
        fall back to the reference LPCNet's 16x1 blocks (dense compute)."""
        w = params["gru_a_wh"].detach().cpu().numpy()
        H, G = w.shape
        if block is None:
            block = (_sampler.ROW_BLOCK, _sampler.COL_BLOCK)
            if H % _sampler.ROW_BLOCK or G % _sampler.COL_BLOCK:
                block = (min(16, H), 1)
        bh, bw = block
        blocks = w.reshape(H // bh, bh, G // bw, bw)
        mags = np.abs(blocks).sum(axis=(1, 3))
        k = max(1, int(round(density * mags.size)))
        threshold = np.partition(mags.ravel(), -k)[-k]
        keep = (mags >= threshold).astype(np.float32)
        mask = np.repeat(np.repeat(keep, bh, axis=0), bw, axis=1)
        with torch.no_grad():
            params[MASK].copy_(torch.as_tensor(mask))
            params["gru_a_wh"].mul_(params[MASK])
        return params
