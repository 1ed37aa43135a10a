"""Many vocoder streams a device over the ranks of a process group
(counterpart of apps/serve_multichip.py).

    python -m dss_tpu_torch.apps.serve_multichip [--devices N]
        [--streams-per-device S] [--frames F] [--steps K]
        [--weights W.npz] [--device cuda|cpu]

Each rank serves S streams, its slots of the N x S-stream batch
(parallel/shard.py's layout): one call of its ``Vocoder``
(vocoder/lpcnet.py) a serving step, which on the card is the sampler
kernel (K2, or K3 at the checkpoint's bunch) at B = S.  No stream's state
leaves its rank; the ranks meet only at the barriers around the timing and
to gather the result.

Under torchrun (one process a card, NCCL) the world size comes from the
environment:

    torchrun --nproc-per-node N -m dss_tpu_torch.apps.serve_multichip ...

Without a launcher it serves as a world of one on the card, or, with
``--device cpu --devices N``, spawns N gloo ranks on the CPU.

Rank 0 prints one JSON line with the JAX app's keys: the step time of the
slowest rank, the aggregate frames a second and the real-time factor over
all streams.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        "Serve N batched vocoder streams over the ranks of a process group.")
    parser.add_argument("--devices", type=int, default=None,
                        help="Ranks (default: torchrun's world size, else "
                             "1); with --device cpu and no torchrun this "
                             "many gloo ranks are spawned.")
    parser.add_argument("--streams-per-device", type=int, default=8)
    parser.add_argument("--frames", type=int, default=50,
                        help="Frames (10 ms each) per serving step.")
    parser.add_argument("--steps", type=int, default=3,
                        help="Timed serving steps (after one warm-up).")
    parser.add_argument("--weights", default=None,
                        help="Trained vocoder weights (.npz); a vocoder "
                             "seeded with 0 otherwise (the sampler's time "
                             "depends on the mask's kept tiles).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL between ranks) or cpu (gloo).")
    return parser.parse_args(argv)


def serve(args: argparse.Namespace) -> Optional[dict]:
    """One rank's serving loop, in a process group that exists (or a
    world of one that ``make_mesh`` starts); rank 0 returns the result."""
    from ..parallel import make_mesh, shard_batch
    from ..parallel.mesh import axis, mesh_device
    from ..vocoder.lpcnet import Vocoder
    from ..vocoder.net import LPCNetModel

    mesh = make_mesh(args.devices, model_parallel=1, device=args.device)
    world, rank, group = axis(mesh, "data")
    dev = mesh_device(mesh)
    S = args.streams_per_device
    streams = world * S
    # The architecture (the bunch too) rides in the checkpoint.
    weights = args.weights or LPCNetModel().init(
        torch.Generator().manual_seed(0), dev)
    voc = Vocoder(S, "net", weights, device=dev, slot_lo=rank * S,
                  slots=streams)
    features = np.random.default_rng(0).normal(
        scale=0.3, size=(streams, args.frames, 20)).astype(np.float32)
    feats = shard_batch(mesh, features)

    def barrier():
        if world > 1:
            dist.barrier(group=group)

    voc.vocode(feats).cpu()  # warm: the sampler's weight layout
    # One step with the read-back (the latency a caller sees a dispatch)...
    barrier()
    t0 = time.perf_counter()
    voc.vocode(feats).cpu()
    dt_single = time.perf_counter() - t0
    # ...and the marginal cost of chained steps behind one read.
    n = max(args.steps, 2)
    barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        pcm = voc.vocode(feats)
    pcm.cpu()
    dt_chain = time.perf_counter() - t0
    times = torch.tensor([dt_single, max((dt_chain - dt_single) / (n - 1),
                                         1e-9)], dtype=torch.float64,
                         device=dev)
    parts = None
    if world > 1:  # the slowest rank sets the pace; rank 0 gets the audio
        dist.all_reduce(times, op=dist.ReduceOp.MAX, group=group)
        packed = pcm.view(torch.float32)  # int16 pairs: NCCL has no int16
        parts = [torch.empty_like(packed) for _ in range(world)] \
            if rank == 0 else None
        dist.gather(packed, parts, dst=dist.get_global_rank(group, 0),
                    group=group)
    if rank != 0:
        return None
    pcm = torch.cat(parts).view(torch.int16) if parts is not None else pcm
    dt_single, dt = times.tolist()
    total_frames = streams * args.frames
    return {
        "devices": world,
        "streams": streams,
        "frames_per_step": args.frames,
        "dispatch_seconds": dt_single,
        "step_seconds_device": dt,
        "aggregate_frames_per_s": total_frames / dt,
        "realtime_factor": total_frames * 0.01 / dt,
        "pcm_shape": list(pcm.shape),
    }


def _spawned(rank: int, argv, world: int, store: str) -> None:
    from ..parallel.mesh import init_world

    torch.set_num_threads(1)
    init_world(torch.device("cpu"), rank, world,
               dist.FileStore(store, world))
    try:
        out = serve(parse_args(argv))
        if out is not None:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> Optional[dict]:
    """Run the app; returns rank 0's result (None on the other ranks and
    when the ranks were spawned, which print it themselves)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    spawn = (args.device == "cpu" and (args.devices or 1) > 1
             and "WORLD_SIZE" not in os.environ and not dist.is_initialized())
    if spawn:
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_spawned, args=(argv, args.devices,
                                               str(Path(tmp) / "store")),
                               nprocs=args.devices, start_method="spawn")
        return None
    owned = not dist.is_initialized()
    try:
        out = serve(args)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    if out is not None:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
