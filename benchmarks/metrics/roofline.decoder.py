"""D3's share of its roofline: the least time of the word decoder's
inference (2 x 100 bidirectional LSTM and its head, float32 operations at
67 TFLOP/s, counted from each word's frames) over the device time of the
kernels named ``bilstm_decoder_kernel`` in the profiler's trace."""

from benchmarks import roofline
from benchmarks.trace import device_seconds

KERNEL = "bilstm_decoder_kernel"


def read(rec, ctx):
    t, frames = rec.get("trace"), rec.get("word_frames")
    if not t or not frames:
        return None
    n, dev_s = device_seconds(t, KERNEL)
    if not n or dev_s <= 0:
        return None
    least = sum(roofline.decoder(T) for T in frames) / roofline.PEAK_F32_FLOPS
    return 100.0 * least / len(frames) * n / dev_s
