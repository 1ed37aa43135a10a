"""Time the port's LPCNet sampler kernel per 50-frame block at every cluster
size, and look inside one step.

The port builds its kernel for clusters of 8 blocks per stream and without
instrumentation.  This tool builds four more copies of the kernels
(``-DDSS_SAMPLER_CLUSTER=4``, ``=2``, ``=1``, and ``-DDSS_SAMPLER_TRACE`` at
8) and, for the shipped checkpoints at bunch 1, 2, 4 and 8 (one stream) and
bunch 1 and 4 at eight streams, times each with what its launch keeps
resident in shared memory; then, from the traced copy, the SM clocks
between the phases of one step and what the trace points cost.  All in one
process on one card, so the times compare.  Needs an H100 and nvcc:

    python tools/torch_sampler_cluster_sizes.py [--out FILE.json]
"""

import argparse
import json
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from dss_tpu_torch.ops import _cuda  # noqa: E402
from dss_tpu_torch.ops import sampler as smp  # noqa: E402
from dss_tpu_torch.vocoder import net as tnet  # noqa: E402
from dss_tpu_torch.vocoder.lpc import bands_from_cepstrum, \
    lpc_from_bands  # noqa: E402
from dss_tpu_torch.vocoder.lpcnet import _load_params  # noqa: E402

TRACED = ("DSS_SAMPLER_TRACE",)
_library = _cuda.library


def use_build(defines, cluster):
    """Point the sampler's wrappers at the copy built with ``defines``,
    whose clusters have ``cluster`` blocks.  Weight sets prepared before
    keep the layout of the size they were first launched with, so prepare
    them anew."""
    lib = _library(defines)
    _cuda.library = lambda: lib
    smp.CLUSTER = cluster
    return lib


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def inputs(dev, S, batch, frames=50):
    name = "vocoder_speech.npz" if S == 1 else f"vocoder_speech_b{S}.npz"
    p = _load_params(REPO / "weights" / name, dev)
    m = tnet.LPCNetModel.from_params(p)
    g = torch.Generator().manual_seed(1)
    feats = torch.randn((batch, frames, 20), generator=g) * 0.3
    feats[..., 0] -= 4.0
    feats = feats.to(dev)
    cond = m.condition(p, feats)
    lpc, _ = lpc_from_bands(bands_from_cepstrum(feats[..., :18]))
    temp = 1.0 + 1.5 * torch.clamp(feats[..., 19] + 0.5, 0.0, 1.0)
    st = tnet.net_vocoder_init(m, batch, device=dev)
    return (tnet.sampler_weights_for(m, p),
            (st.h_a, st.h_b, st.sig_mem, st.exc_idx),
            cond.transpose(0, 1).contiguous(),
            lpc.transpose(0, 1).contiguous(),
            temp.transpose(0, 1).contiguous())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda")
    builds = [((), 8, False), (TRACED, 8, True),
              (("DSS_SAMPLER_CLUSTER=4",), 4, False),
              (("DSS_SAMPLER_CLUSTER=2",), 2, False),
              (("DSS_SAMPLER_CLUSTER=1",), 1, False)]
    with ThreadPoolExecutor(len(builds)) as pool:  # the nvcc runs side by side
        list(pool.map(lambda b: _cuda.build(b[0]), builds))
    rows = []
    for defines, N, traced in builds:
        use_build(defines, N)
        for S, batch in ((1, 1), (2, 1), (4, 1), (8, 1), (4, 8), (1, 8)):
            w, carry, cond, lpc, temp = inputs(dev, S, batch)
            noise = tnet.gumbel_noise(0, 0, 50, batch, dev)
            run = smp.sampler_frames if S == 1 else smp.sampler_frames_bunched
            ms = cuda_ms(lambda: run(w, carry, cond, lpc, temp, noise))
            plan = smp.kernel_plan(w, S, cond.shape[2], lpc.shape[2])
            row = dict(S=S, B=batch, trace_points=traced, ms=ms,
                       us_per_step=ms * 1e3 * S / 8000, **plan)
            rows.append(row)
            print(json.dumps(row), flush=True)
    # Where a step's time goes, at the cluster size the port uses: SM clocks
    # between the TRACE points of the traced copy.
    lib = use_build(TRACED, 8)
    lib.dss_lpcnet_sampler_set_trace.argtypes = [ctypes.c_void_p]
    lib.dss_lpcnet_sampler_set_trace.restype = None
    names = ("GRU-A gather, update, h_a out", "wx_b partial out",
             "wait for exchange 1", "GRU-B", "heads, logits out",
             "wait for exchange 2", "tail: loads of round 0",
             "tail: argmax of round 0", "tail: sample, encode of round 0",
             "tail: the other rounds", "join")
    traces = []
    for S in (1, 2, 4, 8):
        w, carry, cond, lpc, temp = inputs(dev, S, 1)
        noise = tnet.gumbel_noise(0, 0, 50, 1, dev)
        run = smp.sampler_frames if S == 1 else smp.sampler_frames_bunched
        stamps = torch.zeros(13, dtype=torch.int64, device=dev)
        lib.dss_lpcnet_sampler_set_trace(stamps.data_ptr())
        run(w, carry, cond, lpc, temp, noise)
        torch.cuda.synchronize()
        lib.dss_lpcnet_sampler_set_trace(None)
        d = (stamps[1:12] - stamps[:11]).tolist()
        traces.append(dict(S=S, cycles=dict(zip(names, d)), total=sum(d),
                           next_gru_a_done_before_tail=int(stamps[6] - stamps[12])))
        print(json.dumps(traces[-1]), flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print("SM clock now, max:", clocks)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, rows=rows, traces=traces,
                                                  sm_clocks=clocks),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
