"""Per serving step, the step's wall time less the sampler kernel's
device time (profiler): the host's and the other launches' share."""

from benchmarks.trace import device_seconds

KERNEL = "lpcnet_sampler_kernel"


def read(rec, ctx):
    t = rec.get("trace")
    if rec["kind"] != "serve" or not t or not rec["steps"]:
        return None
    n, dev_s = device_seconds(t, KERNEL)
    if not n:
        return None
    return (rec["window_s"] - dev_s) / rec["steps"] * 1e3
