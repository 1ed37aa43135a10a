"""D1's share of its roofline: the least time of the DSP vocoder's word
calls (counted from their frames) over their device time in the
profiler's trace."""

from benchmarks import roofline
from benchmarks.trace import device_seconds

KERNEL = "dsp_synthesis_kernel"


def read(rec, ctx):
    t, calls = rec.get("trace"), rec.get("vocoder_calls")
    if not t or not calls or rec.get("vocoder") != "dsp":
        return None
    n, dev_s = device_seconds(t, KERNEL)
    if not n or dev_s <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.d1(T)) for T in calls)
    return 100.0 * least / len(calls) * n / dev_s
