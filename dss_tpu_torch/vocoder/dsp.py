"""Deterministic source-filter LPC vocoder (counterpart of
dss_tpu/vocoder/dsp.py).

160 samples of 16 kHz audio per 20-dim feature frame, with no trained
weights: the cepstrum gives the envelope and, through Levinson-Durbin, a
16-tap all-pole filter; the excitation mixes a pulse train and noise by the
pitch features.  It is the always-available backend, the one
config/debug_settings.ini ships with.

On the card a call is one launch of kernel D1
(``ops/dsp_synthesis.py::dsp_vocode``): its prologue computes the
frame-rate part (pitch decode, cepstrum -> bands -> LPC, gain and voicing)
and the noise, and the sample loop runs frame-parallel.  On the CPU the
frame-rate part runs batched over all frames and streams in eager PyTorch,
with each frame's arithmetic independent of the others
(``lpc_from_cepstrum_framewise``), and the sample loop is one call of
``ops/dsp_synthesis.py::dsp_synthesis`` (the host-compiled serial loop).

Noise.  The JAX package draws it from its PRNG (``jax.random.split`` per
frame), which has no torch counterpart.  Here a frame's 160 Gaussian values
come from a counter-based hash of (stream seed, absolute frame index) and
Box-Muller, so chunked synthesis equals one pass bit for bit and kernel and
plain version see the same noise.  ``dsp_synthesize_frames(noise=...)``
takes the noise from the caller instead (the parity tests hand it the JAX
package's).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.dsp_synthesis import DspCarry, dsp_synthesis, dsp_vocode
from ..utils import tracing
from .features import pitch_feature_decode
from .lpc import FRAME_SIZE, LPC_ORDER, NB_BANDS, WINDOW_SIZE, \
    lpc_from_cepstrum_framewise
from .net import _M32, _fmix32


class DspVocoderState(NamedTuple):
    """Carried synthesis state of B streams."""

    sig_mem: torch.Tensor      # [B, LPC_ORDER] recent output (pre-de-emphasis)
    pitch_phase: torch.Tensor  # [B] int32, samples until the next pulse
    deemph_mem: torch.Tensor   # [B] f32
    seed: int                  # stream i draws its noise from seed + i
    frame_ctr: int             # absolute index of the next frame


def dsp_vocoder_init(seed: int = 0, batch: int = 1, device=None
                     ) -> DspVocoderState:
    dev = torch.device("cpu" if device is None else device)
    return DspVocoderState(
        sig_mem=torch.zeros((batch, LPC_ORDER), device=dev),
        pitch_phase=torch.zeros((batch,), dtype=torch.int32, device=dev),
        deemph_mem=torch.zeros((batch,), device=dev),
        seed=int(seed), frame_ctr=0)


def gaussian_noise(seed: int, batch: int, first_frame: int, frames: int,
                   device) -> torch.Tensor:
    """Standard normal noise [batch, frames, FRAME_SIZE] for absolute frames
    ``first_frame ..`` of streams seeded seed, seed + 1, ...: a counter hash
    of (stream seed, frame, position) as ``net.gumbel_noise`` draws, two
    uniforms per pair of samples, Box-Muller."""
    f = torch.arange(first_frame, first_frame + frames, dtype=torch.long,
                     device=device) & _M32
    seeds = (int(seed) + torch.arange(batch, dtype=torch.long,
                                      device=device)) & _M32
    key = _fmix32(_fmix32(f)[None, :] ^ seeds[:, None])          # [B, F]
    j = torch.arange(FRAME_SIZE, dtype=torch.long, device=device)
    bits = _fmix32(key[..., None] ^ j)                           # [B, F, 160]
    u = (bits >> 8).float() * (1.0 / (1 << 24))
    # Even positions give the radius, odd ones the angle.  The logarithm,
    # cosine and sine run over all 160 values of a frame (a multiple of
    # the CPU's vector width), so no frame's values fall to a vectorized
    # loop's scalar tail, which rounds them otherwise: a frame's noise does
    # not depend on how many frames share the call.
    r = torch.sqrt(-2.0 * torch.log(1.0 - u))[..., 0::2]         # 1 - u > 0
    theta = (2.0 * math.pi) * u
    return torch.cat([r * torch.cos(theta)[..., 1::2],
                      r * torch.sin(theta)[..., 1::2]], dim=-1)


def to_int16(pcm: torch.Tensor) -> np.ndarray:
    """Float PCM in [-1, 1] -> int16 by scale, clip and truncation (the
    reference's conversion), converted on the tensor's device."""
    return torch.clamp(pcm * 32767.0, -32768, 32767).to(torch.int16) \
        .cpu().numpy()


def frame_parameters(features: torch.Tensor):
    """The frame-rate part, batched over [.., T, 20] features: (lpc
    [.., T, 16], gain, v_mix, voiced (bool), period (int32)), each [.., T],
    the per-frame inputs of the sample loop."""
    period, corr = pitch_feature_decode(features[..., NB_BANDS],
                                        features[..., NB_BANDS + 1])
    lpc, res_energy = lpc_from_cepstrum_framewise(features[..., :NB_BANDS])
    # Excitation energy per sample so that a frame's power matches the
    # envelope's residual energy (WINDOW energy -> per sample).
    gain = torch.sqrt(torch.clamp(res_energy, min=1e-12) / WINDOW_SIZE * 2.0)
    v_mix = torch.clamp((corr - 0.3) / 0.5, 0.0, 1.0)
    return (lpc.contiguous(), gain, v_mix, corr > 0.3,
            period.to(torch.int32))


@torch.no_grad()
def dsp_synthesize_frames(state: DspVocoderState, features: torch.Tensor,
                          noise: Optional[torch.Tensor] = None):
    """Features [T, 20] (one stream) or [B, T, 20] -> (float PCM in [-1, 1]
    [T*160] or [B, T*160], new state).  ``noise`` [(B,) T, 160] replaces
    the state's own noise for these frames."""
    single = features.dim() == 2
    feats = features[None] if single else features
    B, T = feats.shape[:2]
    with tracing.span("vocoder.dsp", streams=B, frames=T):
        if noise is not None:
            noise = (noise[None] if single else noise).to(torch.float32)
        carry = DspCarry(state.sig_mem, state.pitch_phase, state.deemph_mem)
        if feats.is_cuda:
            pcm, carry = dsp_vocode(feats.to(torch.float32), carry,
                                    state.seed, state.frame_ctr, noise)
        else:
            if noise is None:
                noise = gaussian_noise(state.seed, B, state.frame_ctr, T,
                                       feats.device)
            pcm, carry = dsp_synthesis(*frame_parameters(feats), noise,
                                       carry)
    new_state = DspVocoderState(*carry, seed=state.seed,
                                frame_ctr=state.frame_ctr + T)
    return (pcm[0] if single else pcm), new_state


def dsp_frame_synthesize(state: DspVocoderState, features: torch.Tensor,
                         noise: Optional[torch.Tensor] = None):
    """One frame: features [20] (or [B, 20]) -> (PCM [160] (or [B, 160]),
    new state)."""
    pcm, state = dsp_synthesize_frames(
        state, features[..., None, :],
        None if noise is None else noise[..., None, :])
    return pcm, state


class LPCVocoder:
    """Stateful single-stream wrapper with the LPCNet ``synthesize``
    contract.  Runs on the card unless ``device`` says otherwise."""

    def __init__(self, seed: int = 0, device=None):
        self._seed = seed
        self.device = resolve_device(device)
        self.reset_decoder()

    def reset_decoder(self) -> None:
        self._state = dsp_vocoder_init(self._seed, 1, self.device)

    def synthesize(self, features: np.ndarray) -> np.ndarray:
        """features [20] float32 -> int16 [160] (10 ms at 16 kHz)."""
        return self.synthesize_frames(np.asarray(features).reshape(1, -1))

    def synthesize_frames(self, features: np.ndarray) -> np.ndarray:
        """features [T, 20] -> int16 [T*160] in one call."""
        feats = torch.as_tensor(np.asarray(features, np.float32),
                                device=self.device)
        pcm, self._state = dsp_synthesize_frames(self._state, feats)
        return to_int16(pcm)
