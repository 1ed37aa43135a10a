"""Public vocoder API (counterpart of dss_tpu/vocoder/lpcnet.py).

* ``Vocoder`` — the one place a vocoder is assembled: the backend, for
  ``net`` the checkpoint, model and prepared sampler weights, the carried
  state and the device-side call; the classes below and the word units
  (runtime/units.py) hold one;
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
network, which needs ``weights`` (an ``.npz`` path or a dict of arrays or
tensors; see ``packaged_weights`` in this package): the bunch is read from
the checkpoint, so bunched checkpoints load like any other.  There is one
sampler per device, so the JAX package's ``use_pallas`` switch has no
counterpart.  Every class runs on the card unless ``device`` says
otherwise.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import sampler as _sampler  # the module: see vocoder/net.py
from .dsp import dsp_synthesize_frames, dsp_vocoder_init, int16_pcm
from .lpc import FRAME_SIZE, NB_FEATURES
from .net import LPCNetModel, net_synthesize_frames, net_vocoder_init, \
    sampler_weights_for

logger = logging.getLogger("dss_tpu_torch.vocoder.lpcnet")


def _load_params(weights, device) -> Optional[Dict[str, torch.Tensor]]:
    """A checkpoint (``.npz`` path, or a dict of arrays or tensors) as a
    dict of tensors on ``device``; None passes through."""
    if weights is None:
        return None
    if isinstance(weights, str) or hasattr(weights, "__fspath__"):
        with np.load(os.fspath(weights)) as f:
            weights = {k: f[k] for k in f.files}
    return {k: torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.asarray(v), device=device)
            for k, v in weights.items()}


class Vocoder:
    """A vocoder of ``batch`` streams: the backend, for ``net`` its
    checkpoint (``weights``), model and prepared sampler weights, the
    carried state and the synthesis call.  The streams are rows
    ``slot_lo ..`` of a ``slots``-stream batch (0: the batch is these
    rows), so that a shard of a batch draws the whole batch's noise."""

    def __init__(self, batch: int, backend: str, weights, *,
                 model: Optional[LPCNetModel] = None, seed: int = 0,
                 temperature_scale: float = 1.0, quiet_sharpen: bool = False,
                 device=None, slot_lo: int = 0, slots: int = 0):
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
        self._rows = dict(slot_lo=slot_lo, slots=slots)
        if backend == "net":
            self.params = _load_params(weights, self.device)
            self.model = model if model is not None \
                else LPCNetModel.from_params(self.params)
            self.sampler_w = sampler_weights_for(self.model, self.params)
            mask = self.params.get("gru_a_mask")
            kept = 1.0 if mask is None else \
                _sampler.tile_sparse_pattern(mask.cpu().numpy())[1]
            logger.info(f"vocoder bunch {self.model.bunch}; GRU-A mask "
                        f"keeps {kept:.1%} of [16 x 128] tiles (the sampler "
                        f"kernel reads only those)")
        self.state = self._fresh_state()

    def _fresh_state(self):
        if self.backend == "dsp":
            return dsp_vocoder_init(self._seed, self.batch, self.device)
        return net_vocoder_init(self.model, batch=self.batch,
                                seed=self._seed, device=self.device
                                )._replace(**self._rows)

    def _synthesize(self, state, features: torch.Tensor):
        """features [batch, T, 20] on the device -> (float PCM [batch,
        T*160], state)."""
        if self.backend == "dsp":
            return dsp_synthesize_frames(state, features)
        return self._net_synthesize(
            self.model, self.params, state, features,
            temperature_scale=self.temperature_scale,
            quiet_sharpen=self.quiet_sharpen, sampler_weights=self.sampler_w)

    @staticmethod
    def _net_synthesize(*args, **kw):
        """``net_synthesize_frames``, looked up in this module at call
        time."""
        return net_synthesize_frames(*args, **kw)

    def vocode(self, features: torch.Tensor) -> torch.Tensor:
        """features [batch, T, 20] on the device -> int16 PCM [batch,
        T*160] on the device; the carried state advances."""
        pcm, self.state = self._synthesize(self.state, features)
        return int16_pcm(pcm)

    def reset(self) -> None:
        self.state = self._fresh_state()

    def warm(self, n_frames: int) -> None:
        """Run an ``n_frames`` synthesis on a throwaway state and read it
        back (builds and loads the kernel, fills the device's caches)
        without touching the carried state."""
        pcm, _ = self._synthesize(self._fresh_state(), torch.zeros(
            (self.batch, n_frames, NB_FEATURES), device=self.device))
        int16_pcm(pcm).cpu()

    def _features(self, features: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(features, np.float32)).to(
            self.device)


class LPCNet(Vocoder):
    """Single-stream vocoder with the reference's frame API."""

    LPCNET_FRAME_SIZE = FRAME_SIZE

    def __init__(self, backend: str = "net", weights=None, **kw):
        """``kw``: ``Vocoder``'s keywords (model, seed, temperature_scale,
        quiet_sharpen, device)."""
        super().__init__(1, backend, weights, **kw)

    def reset_decoder(self) -> None:
        self.reset()

    def synthesize(self, features: np.ndarray) -> np.ndarray:
        """features [20] float32 -> int16 [160] (10 ms at 16 kHz)."""
        return self.synthesize_frames(
            np.asarray(features, np.float32).reshape(1, NB_FEATURES))

    def synthesize_frames(self, features: np.ndarray) -> np.ndarray:
        """features [T, 20] -> int16 [T*160]."""
        return self.vocode(self._features(features)[None])[0].cpu().numpy()


class BatchedLPCNet(Vocoder):
    """N-stream parallel vocoder: one call advances all streams in one
    launch (net: a cluster of the sampler kernel per stream; dsp: a warp of
    D1 per stream)."""

    def __init__(self, batch: int, backend: str = "net", weights=None,
                 **kw):
        """``kw``: as ``LPCNet``'s."""
        super().__init__(batch, backend, weights, **kw)

    def synthesize_frames(self, features: np.ndarray) -> np.ndarray:
        """features [N, T, 20] -> int16 [N, T*160]."""
        features = np.asarray(features, np.float32)
        if features.shape[0] != self.batch:
            raise ValueError(f"expected {self.batch} streams, got "
                             f"{features.shape[0]}")
        return self.vocode(self._features(features)).cpu().numpy()


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
