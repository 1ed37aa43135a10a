"""Public vocoder API (counterpart of dss_tpu/vocoder/lpcnet.py).

* ``LPCNet`` — one stream with the reference binding's frame API:
  ``synthesize(features[20]) -> int16[160]``, ``synthesize_frames``,
  ``reset_decoder``, ``warm``;
* ``BatchedLPCNet`` — N streams advanced together, one sampler block per
  stream;
* ``LPCFeatureFile`` — iterator over LPCNet ``.f32`` feature dumps.

Two backends: ``backend="dsp"``, the weight-free source-filter vocoder
(vocoder/dsp.py; its sample loop is kernel D1 on the card, all streams in
one launch, stream i seeded ``seed + i`` as the JAX package's per-stream
``LPCVocoder(seed + i)``), and ``backend="net"``, the neural sample-rate
network, which needs ``weights`` (an ``.npz`` path or a dict of arrays; see
``packaged_weights`` in this package): the bunch is read from the
checkpoint, so bunched checkpoints load like any other.  There is one
sampler per device, so the JAX package's ``use_pallas`` switch has no
counterpart.  Both classes run on the card unless ``device`` says
otherwise.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import sampler as _sampler  # the module: see vocoder/net.py
from .dsp import dsp_synthesize_frames, dsp_vocoder_init, to_int16
from .lpc import FRAME_SIZE, NB_FEATURES
from .net import LPCNetModel, net_synthesize_frames, net_vocoder_init, \
    sampler_weights_for


def _load_params(weights, device) -> Optional[Dict[str, torch.Tensor]]:
    """A checkpoint (``.npz`` path, or a dict of arrays) as a dict of
    tensors on ``device``; None passes through."""
    if weights is None:
        return None
    if isinstance(weights, str) or hasattr(weights, "__fspath__"):
        with np.load(os.fspath(weights)) as f:
            weights = {k: f[k] for k in f.files}
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in weights.items()}


def _sparse_pattern_of(params):
    """(tile keep-pattern, kept fraction) of the GRU-A recurrent mask at
    [16 x 128] tiles, or (None, 1.0) when the mask is dense or absent."""
    if params is None or "gru_a_mask" not in params:
        return None, 1.0
    return _sampler.tile_sparse_pattern(
        params["gru_a_mask"].detach().cpu().numpy())


class _Vocoder:
    """What the two public classes share: the backend, for ``net`` its
    checkpoint, model and prepared sampler weights, the carried state and
    the synthesis call."""

    def __init__(self, batch: int, backend: str, weights,
                 model: Optional[LPCNetModel], seed: int,
                 temperature_scale: float, quiet_sharpen: bool, device):
        if backend not in ("dsp", "net"):
            raise ValueError(f"Unknown vocoder backend: {backend}")
        if backend == "net" and weights is None:
            raise ValueError(
                "backend='net' needs weights: an .npz path or a dict of "
                "arrays, e.g. dss_tpu_torch.vocoder.packaged_weights()")
        self.backend = backend
        self.batch = batch
        self.device = resolve_device(device)
        # Multiplies the pitch-correlation-derived sharpening; 1.0 = default.
        self.temperature_scale = float(temperature_scale)
        # Energy-gated quiet-frame sharpening (vocoder/net.py QUIET_C0);
        # off by default for offline scoring.
        self.quiet_sharpen = bool(quiet_sharpen)
        self._seed = seed
        if backend == "net":
            self._params = _load_params(weights, self.device)
            self._model = model if model is not None \
                else LPCNetModel.from_params(self._params)
            self._sampler_w = sampler_weights_for(self._model, self._params)
        self._state = self._fresh_state()

    def _fresh_state(self):
        if self.backend == "dsp":
            return dsp_vocoder_init(self._seed, self.batch, self.device)
        return net_vocoder_init(self._model, batch=self.batch,
                                seed=self._seed, device=self.device)

    def _run(self, state, features: np.ndarray):
        """features [batch, T, 20] -> (float PCM [batch, T*160], state)."""
        feats = torch.as_tensor(np.asarray(features, np.float32)).to(
            self.device)
        if self.backend == "dsp":
            return dsp_synthesize_frames(state, feats)
        return net_synthesize_frames(
            self._model, self._params, state, feats,
            temperature_scale=self.temperature_scale,
            quiet_sharpen=self.quiet_sharpen,
            sampler_weights=self._sampler_w)


class LPCNet(_Vocoder):
    """Single-stream vocoder with the reference's frame API."""

    LPCNET_FRAME_SIZE = FRAME_SIZE

    def __init__(self, backend: str = "net", weights=None,
                 model: Optional[LPCNetModel] = None, seed: int = 0,
                 temperature_scale: float = 1.0,
                 quiet_sharpen: bool = False, device=None):
        super().__init__(1, backend, weights, model, seed, temperature_scale,
                         quiet_sharpen, device)

    def reset_decoder(self) -> None:
        self._state = self._fresh_state()

    def synthesize(self, features: np.ndarray) -> np.ndarray:
        """features [20] float32 -> int16 [160] (10 ms at 16 kHz)."""
        return self.synthesize_frames(
            np.asarray(features, np.float32).reshape(1, NB_FEATURES))

    def synthesize_frames(self, features: np.ndarray) -> np.ndarray:
        """features [T, 20] -> int16 [T*160]."""
        pcm, self._state = self._run(
            self._state, np.asarray(features, np.float32)[None])
        return to_int16(pcm[0])

    def warm(self, n_frames: int) -> None:
        """Run an ``n_frames`` synthesis on a throwaway state (builds and
        loads the kernel, fills the device's caches) without touching the
        decoder state."""
        pcm, _ = self._run(self._fresh_state(),
                           np.zeros((1, n_frames, NB_FEATURES), np.float32))
        pcm.cpu()


class BatchedLPCNet(_Vocoder):
    """N-stream parallel vocoder: one call advances all streams in one
    launch (net: a cluster of the sampler kernel per stream; dsp: a warp of
    D1 per stream)."""

    def __init__(self, batch: int, backend: str = "net", weights=None,
                 model: Optional[LPCNetModel] = None, seed: int = 0,
                 temperature_scale: float = 1.0,
                 quiet_sharpen: bool = False, device=None):
        super().__init__(batch, backend, weights, model, seed,
                         temperature_scale, quiet_sharpen, device)

    def reset(self) -> None:
        self._state = self._fresh_state()

    def synthesize_frames(self, features: np.ndarray) -> np.ndarray:
        """features [N, T, 20] -> int16 [N, T*160]."""
        features = np.asarray(features, np.float32)
        if features.shape[0] != self.batch:
            raise ValueError(f"expected {self.batch} streams, got "
                             f"{features.shape[0]}")
        pcm, self._state = self._run(self._state, features)
        return to_int16(pcm)


class LPCFeatureFile:
    """Iterate 20-of-36 features from an LPCNet ``.f32`` feature dump."""

    def __init__(self, filename: str, loop: bool = False,
                 nb_total_features: int = 36):
        raw = np.fromfile(filename, dtype=np.float32)
        self.features = raw.reshape((-1, nb_total_features))
        self.index = 0
        self.loop = loop

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self.index >= len(self.features):
            raise StopIteration
        features = self.features[self.index]
        self.index += 1
        if self.index == len(self.features) and self.loop:
            self.index = 0
        return features[:NB_FEATURES]
