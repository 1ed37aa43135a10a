"""Serving's share of the card's float32 peak: the sampler model's
operations for every step's B streams x F frames over the window (host
clock), against 67 TFLOP/s."""

from benchmarks import roofline
from benchmarks.metrics_support import kept_tiles


def read(rec, ctx):
    if rec["kind"] != "serve" or not rec["steps"]:
        return None
    flops = rec["steps"] * roofline.k2(rec["streams"], rec["frames"],
                                       kept_tiles(ctx))[1]
    return 100.0 * flops / rec["window_s"] / roofline.PEAK_F32_FLOPS
