"""The sampler kernel's share of its roofline on the word path (one stream,
50-frame chunks; GRU-A at the tiles the mask keeps) over its device time
in the profiler's trace."""

from benchmarks import roofline
from benchmarks.metrics_support import kept_tiles
from benchmarks.trace import device_seconds

KERNEL = "lpcnet_sampler_kernel"


def read(rec, ctx):
    t = rec.get("trace")
    if not t or rec.get("vocoder") != "net":
        return None
    n, dev_s = device_seconds(t, KERNEL)
    if not n or dev_s <= 0:
        return None
    least = roofline.least_seconds(*roofline.k2(1, 50, kept_tiles(ctx)))
    return 100.0 * least * n / dev_s
