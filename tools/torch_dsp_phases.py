"""Time the port's DSP vocoder kernel (D1, csrc/dsp_synthesis.cu) phase by
phase.

The port builds D1 without instrumentation.  This tool builds a second copy
of the kernels with ``-DDSS_DSP_TRACE``, whose first block reads the global
timer at the kernel's start, when phase B (the pitch phases) ends, and
after phases A+B, B' (excitation), C (each frame's carry map), D (the carry
pass) and E (the output).  For a 260-frame word at one stream, eight
streams of 50 frames and one 3600-frame synthesis-queue job (seeded
features through ``dsp_vocode``) it prints each phase's microseconds and
the call's profiler device time in both builds, in one process on one
card.  Needs a CUDA card and nvcc:

    python tools/torch_dsp_phases.py [--out FILE.json]
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from dss_tpu_torch.ops import _cuda  # noqa: E402
from dss_tpu_torch.ops import dsp_synthesis as d1  # noqa: E402

TRACED = ("DSS_DSP_TRACE",)
SHAPES = ((1, 260), (8, 50), (1, 3600))
PHASES = ("A+B", "B'", "C", "D", "E")


def features(batch, frames, seed=1):
    """Seeded features with voiced and unvoiced frames, periods 32-256."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(batch, frames, 20)).astype(np.float32) * 0.3
    f[..., 0] -= 2.0
    f[..., 18] = rng.uniform(-1.36, 3.12, size=(batch, frames))
    f[..., 19] = np.where(rng.random((batch, frames)) < 0.6,
                          rng.uniform(0.0, 0.5, (batch, frames)),
                          rng.uniform(-0.5, -0.2, (batch, frames)))
    return torch.as_tensor(f)


def profiled_ms(fn, reps=20):
    """Device ms a D1 kernel record over ``reps`` calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if "dsp_synthesis_kernel" in e.key:
            total += e.device_time_total
            count += e.count
    return total / count / 1e3 if count else None


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="Also write JSON here.")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dsp_phases: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    plain = _cuda.library()
    traced = _cuda.library(TRACED)
    traced.dss_dsp_trace.argtypes = [ctypes.c_void_p]
    traced.dss_dsp_trace.restype = ctypes.c_int
    out = {"card": torch.cuda.get_device_name(0), "shapes": {}}
    for batch, frames in SHAPES:
        feats = features(batch, frames).to(dev)
        carry = d1.DspCarry(torch.zeros((batch, 16), device=dev),
                            torch.zeros(batch, dtype=torch.int32, device=dev),
                            torch.zeros(batch, device=dev))

        def call():
            return d1.dsp_vocode(feats, carry, 0, 0)
        row = {}
        for name, lib in (("plain", plain), ("traced", traced)):
            _cuda.library = lambda *a, lib=lib: lib
            row[f"{name}_profiler_ms"] = profiled_ms(call)
        call()
        torch.cuda.synchronize()
        stamps = (ctypes.c_longlong * 8)()
        if traced.dss_dsp_trace(ctypes.addressof(stamps)) != 0:
            raise RuntimeError("dss_dsp_trace failed")
        _cuda.library = lambda *a: plain
        t = [v / 1e3 for v in stamps]
        row["phase_us"] = dict(zip(PHASES, np.diff(t[:6]).tolist()))
        row["phase_us"]["B alone"] = t[6] - t[0]
        row["traced_total_us"] = t[5] - t[0]
        out["shapes"][f"B{batch}_T{frames}"] = row
        print(f"D1 B={batch} T={frames}: profiler {row['plain_profiler_ms']:.4f}"
              f" ms ({row['traced_profiler_ms']:.4f} traced); phases (us) "
              + ", ".join(f"{k} {v:.1f}" for k, v in row["phase_us"].items()),
              flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
