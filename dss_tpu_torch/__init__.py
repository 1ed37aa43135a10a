"""dss_tpu_torch — the PyTorch/CUDA port of dss_tpu.

It covers the online closed loop (the fused and the separate packet and
word paths: channel selection, CAR, the 16-section IIR cascade, framing,
log power, z-score, the LSTM nVAD, host segmenting, the bidirectional
LSTM decoder, the neural and the DSP vocoders, emitting int16 PCM), the
offline vocoder entry points, and the offline training path (corpus
preparation, nVAD and decoder training, the synthesis queue, the
audio-quality metrics, and neural vocoder training).

The package imports ``torch``, numpy and scipy only — never ``jax`` and
nothing of ``dss_tpu`` (h5py only inside the calls that read or write an
HDF corpus).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  The kernels (the packet front end, log power, the
LPCNet sample loop, the DSP sample loop, the vocoder trainer's LPC
recursion) are hand-written CUDA C++ under
``csrc/``, built with nvcc at first use; each wrapper takes its plain
PyTorch version only for CPU tensors.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
