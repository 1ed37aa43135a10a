"""The bunched sampler kernel's share of its roofline on the word path (one
stream, 50-frame chunks at the configuration's bunch S; GRU-A at the tiles
the mask keeps) over the device time, in the profiler's trace, of the
kernel instantiated at that S."""

from benchmarks import roofline
from benchmarks.metrics_support import kept_tiles
from benchmarks.trace import device_seconds


def kernel(S: int) -> str:
    """The kernel's name at bunch S as the trace records it, up to its
    arguments: ``void (anonymous namespace)::lpcnet_sampler_kernel<8>(...)``."""
    return f"lpcnet_sampler_kernel<{S}>"


def read(rec, ctx):
    t, voc = rec.get("trace"), ctx["config"]["vocoder"]
    if not t or rec.get("vocoder") != "net" or voc["bunch"] == 1:
        return None
    n, dev_s = device_seconds(t, kernel(voc["bunch"]))
    if not n or dev_s <= 0:
        return None
    least = roofline.least_seconds(*roofline.k3(
        1, 50, voc["bunch"], kept_tiles(ctx), voc["gru_a_units"],
        voc["gru_b_units"], voc["cond_dim"], voc["embed_dim"]))
    return 100.0 * least * n / dev_s
