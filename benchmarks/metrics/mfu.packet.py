"""The packet path's share of the card's float32 peak: the front end's and
the nVAD's operations of every packet call (counted from their samples and
frames) over the calls' own host clock (FusedFrontendVad.step_ms),
against 67 TFLOP/s."""

from benchmarks import roofline


def read(rec, ctx):
    calls, ms = rec.get("fe_call_samples"), rec.get("fe_step_ms")
    if not calls or not ms:
        return None
    flops = sum(roofline.frontend(T)[1] + roofline.nvad(T // 10)
                for T in calls) / len(calls) * len(ms)
    return 100.0 * flops / (sum(ms) * 1e-3) / roofline.PEAK_F32_FLOPS
