"""LPCNet-equivalent vocoder subsystem of the port (counterpart of
dss_tpu/vocoder/): the 20-feature frame interface (18 Bark-scale cepstra,
pitch period, pitch correlation) producing 160 samples of 16 kHz int16 PCM
per 10 ms frame, through the source-filter DSP vocoder (dsp.py, its sample
loop in kernel D1, ops/dsp_synthesis.py) or the neural autoregressive
vocoder (net.py, its sample loop in the sampler kernel, ops/sampler.py);
and the feature encoder (features.py) that turns PCM into those features.

Not ported yet: checkpoint interop (interop.py).
"""

import os

from .mulaw import MULAW_LEVELS, mulaw_decode, mulaw_encode
from .lpc import FRAME_SIZE, LPC_ORDER, NB_BANDS, NB_FEATURES, \
    bands_from_cepstrum, lpc_from_bands
from .net import LPCNetModel
from .dsp import LPCVocoder
from .features import LPCFeatureEncoder
from .lpcnet import BatchedLPCNet, LPCFeatureFile, LPCNet


def _packaged(name):
    path = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        "..", "weights", name))
    return path if os.path.isfile(path) else None


def packaged_weights():
    """Path to the repo's shipped neural-vocoder checkpoint, or None:
    the speech-trained flagship (vocoder_speech.npz), else the synthetic
    source-filter demo anchor (vocoder_synthetic.npz)."""
    return (_packaged("vocoder_speech.npz")
            or _packaged("vocoder_synthetic.npz"))


def packaged_weights_bunched(bunch: int = 2):
    """Path to the shipped bunched checkpoint (``bunch`` samples per
    sample-rate step), or None.  Prefers the speech-trained checkpoint
    (vocoder_speech_b{S}.npz) over the synthetic-corpus one."""
    return (_packaged(f"vocoder_speech_b{bunch}.npz")
            or _packaged(f"vocoder_synthetic_b{bunch}.npz"))


__all__ = [
    "mulaw_encode",
    "mulaw_decode",
    "MULAW_LEVELS",
    "NB_BANDS",
    "NB_FEATURES",
    "LPC_ORDER",
    "FRAME_SIZE",
    "bands_from_cepstrum",
    "lpc_from_bands",
    "packaged_weights",
    "packaged_weights_bunched",
    "LPCNetModel",
    "LPCFeatureEncoder",
    "LPCVocoder",
    "LPCNet",
    "BatchedLPCNet",
    "LPCFeatureFile",
]
