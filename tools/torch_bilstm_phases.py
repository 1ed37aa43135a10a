"""Time the word decoder's kernel (D3, csrc/bilstm_decoder.cu) phase by
phase.

The port builds D3 without instrumentation.  This tool builds a second copy
of the kernels with ``-DDSS_BILSTM_TRACE``, whose first block reads the
global timer at the kernel's start and after each layer's input
projections, each layer's recurrence and the regressor, and sums the SM
clocks of its recurrent steps by part: the product with its reduction, the
gate activations, the cell, the barrier (and the clocks of the whole
recurrences, which give the SM's clock rate over them).  For one row of the
deployed decoder (2 x 100 bidirectional, 64 inputs, 20 outputs, seeded
weights) at each ``--frames`` it prints each phase's microseconds, the
clocks a step by part and the launch's profiler device time in both
builds, in one process on one card.  Needs a CUDA card and nvcc:

    python tools/torch_bilstm_phases.py [--frames 137,250] [--out FILE.json]
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path
from unittest import mock

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from dss_tpu_torch.models.decoder import \
    BidirectionalSpeechSynthesisModel  # noqa: E402
from dss_tpu_torch.models.lstm import seeded_init  # noqa: E402
from dss_tpu_torch.ops import _cuda  # noqa: E402
from dss_tpu_torch.ops.bilstm import bilstm_decode, \
    decoder_weights  # noqa: E402

TRACED = ("DSS_BILSTM_TRACE",)


def profiled_ms(fn, reps=20):
    """Device ms a D3 launch over ``reps`` calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if "bilstm_decoder_kernel" in e.key]
    return sum(e.device_time_total for e in ev) / max(1, sum(
        e.count for e in ev)) / 1e3


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", default="137,250")
    parser.add_argument("--out", default=None, help="Also write JSON here.")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bilstm_phases: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    traced = _cuda.library(TRACED)
    traced.dss_bilstm_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    traced.dss_bilstm_trace.restype = ctypes.c_int
    model = seeded_init(BidirectionalSpeechSynthesisModel(2, 100, 64), 0
                        ).to(dev).eval()
    w = decoder_weights(model.lstm, model.regressor)
    out = {"card": torch.cuda.get_device_name(0), "frames": {}}
    stamps = (ctypes.c_longlong * 16)()
    with torch.no_grad():
        for T in (int(t) for t in args.frames.split(",")):
            g = torch.Generator().manual_seed(T)
            x = torch.randn((1, T, 64), generator=g).to(dev)
            call = lambda: bilstm_decode(x, [T], w, None, T)  # noqa: E731
            rec = {"plain_build_ms": profiled_ms(call)}
            with mock.patch.object(_cuda, "library", lambda *a: traced):
                rec["traced_build_ms"] = profiled_ms(call)
                _cuda.check(traced.dss_bilstm_trace(stamps, 1), "trace")
                call()
                torch.cuda.synchronize()
                _cuda.check(traced.dss_bilstm_trace(stamps, 0), "trace")
            ns = list(stamps)
            names = ["project0", "recur0", "project1", "recur1", "regress"]
            rec["phases_us"] = {n: (ns[i + 1] - ns[i]) / 1e3
                                for i, n in enumerate(names)}
            steps = max(1, ns[14])
            rec["steps"] = ns[14]
            rec["clocks_a_step"] = {
                n: ns[10 + i] / steps for i, n in
                enumerate(("product", "activations", "cell", "barrier"))}
            rec["ns_a_step"] = (ns[2] - ns[1] + ns[4] - ns[3]) / steps
            rec["sm_ghz"] = ns[15] / (ns[2] - ns[1] + ns[4] - ns[3])
            out["frames"][T] = rec
            print(f"T={T}: {json.dumps(rec)}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
