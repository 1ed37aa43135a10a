"""The front-end kernel's share of its roofline: the least time of its
packet calls (bytes or float32 operations, counted from their shapes) over
their device time in the profiler's trace."""

from benchmarks import roofline
from benchmarks.trace import device_seconds

KERNEL = "filter_log_power_kernel"


def read(rec, ctx):
    t, calls = rec.get("trace"), rec.get("fe_call_samples")
    if not t or not calls:
        return None
    n, dev_s = device_seconds(t, KERNEL)
    if not n or dev_s <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.frontend(T)) for T in calls)
    return 100.0 * least / len(calls) * n / dev_s
