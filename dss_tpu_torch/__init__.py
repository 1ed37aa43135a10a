"""dss_tpu_torch — the PyTorch/CUDA port of dss_tpu's online closed loop.

This first slice covers the online word path: the fused packet front end
(channel selection, CAR, the 16-section IIR cascade, warm-start framing,
log power, z-score) with the unidirectional LSTM nVAD, host-side
segmenting, and the fused word step (bidirectional LSTM decoder + the
bunch-1 neural LPCNet vocoder), emitting int16 PCM.

The package imports ``torch``, numpy and scipy only — never ``jax`` and
nothing of ``dss_tpu``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.  The two hot kernels (log power and the LPCNet
sample loop) are hand-written CUDA C++ under ``csrc/``, built with nvcc at
first use; each wrapper takes its plain PyTorch version only for CPU
tensors.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
