"""Microbenchmark of the LPCNet sampler kernel on the card (counterpart of
tools/sampler_microbench.py).

Times ``ops/sampler.py::sampler_frames`` (K2, bunch 1) and
``sampler_frames_bunched`` (K3, bunch 2 / 4 / 8) on a freshly initialised
full-width model (GRU-A 384, seeded) at ``--frames`` x ``--batch``, stochastic
at temperature 1.5 on Gumbel noise drawn before the clock starts: one call
with a synchronize (the best of three, ``rtf_call``), and ``--chain``
calls, each carrying the last one's state, behind one synchronize and timed
by CUDA events (the best of ``--reps``), which gives the kernel's time a
call (``rtf_device``, us/sample).  The sparse variants take GRU-A's tile
pattern from ``--weights``' ``gru_a_mask`` (random 20% of the [16 x 128]
tiles when it has none); the dense ones keep every tile::

    python tools/torch_sampler_microbench.py [--frames 100] [--chain 24] \\
        [--variants sparse-f32,bunch8-sparse] [--weights W.npz] [--device cpu]

The variants are the ones the CUDA kernel has: ``dense-f32``,
``sparse-f32`` and ``bunch{2,4,8}-{dense,sparse}``.  The JAX tool's other
variants (bf16 weights, the Mosaic schedules) and its ``--ablate`` have no
counterpart, because the kernel has one numeric path (float32, one
schedule): they raise.  On the CPU the calls run the plain version and the
times are the host's (no device figure).  tools/torch_sampler_cluster_sizes.py
measures what this tool does not: the cluster sizes, the kernel's trace
points and the SM clocks between its phases.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dss_tpu_torch.device import resolve_device  # noqa: E402
from dss_tpu_torch.ops import sampler as _sampler  # noqa: E402
from dss_tpu_torch.vocoder.net import FRAME_SIZE, LPCNetModel, \
    gumbel_noise, net_vocoder_init, sampler_weights_for  # noqa: E402

# name -> (bunch, sparse)
VARIANTS = {"dense-f32": (1, False), "sparse-f32": (1, True)}
VARIANTS.update({f"bunch{S}-{kind}": (S, kind == "sparse")
                 for S in _sampler.BUNCHES for kind in ("dense", "sparse")})


def variant(name: str):
    """(bunch, sparse) of a variant name; raises on the JAX tool's names
    that the kernel has no counterpart for, and on unknown names."""
    if name not in VARIANTS:
        raise ValueError(
            f"variant {name!r} has no counterpart: the CUDA sampler has one "
            f"numeric path (float32 weights, one schedule) at bunch 1, 2, 4 "
            f"and 8, so the JAX tool's bf16, Mosaic-schedule and ablation "
            f"variants do not exist here; variants: {', '.join(VARIANTS)}")
    return VARIANTS[name]


def sparse_mask(weights: str, shape) -> np.ndarray:
    """GRU-A's mask from a checkpoint, else random 20% of the [16 x 128]
    tiles (the first row of tiles kept), as the JAX tool draws it."""
    try:
        with np.load(weights) as ck:
            mask = np.asarray(ck["gru_a_mask"], np.float32)
        print(f"sparse mask from {weights}")
        return mask
    except (FileNotFoundError, KeyError):
        rng = np.random.default_rng(7)
        H, G = shape
        keep = rng.random((H // _sampler.ROW_BLOCK,
                           G // _sampler.COL_BLOCK)) < 0.2
        keep[0, :] = True
        print("sparse mask: random 20% tiles")
        return np.repeat(np.repeat(keep.astype(np.float32),
                                   _sampler.ROW_BLOCK, 0),
                         _sampler.COL_BLOCK, 1)


def pattern_summary(mask: np.ndarray):
    """(kept fraction, kept row blocks of each column group) of a mask's
    tile pattern; the JAX tool prints the same two."""
    pattern, kept = _sampler.tile_sparse_pattern(mask)
    rows = [len(r) for r in pattern] if pattern is not None else None
    return kept, rows


def _setup(S: int, sparse: bool, mask: np.ndarray, B: int, device):
    """(sampler, weights, fresh-carry function) of one variant."""
    model = LPCNetModel(bunch=S)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    if sparse:
        params["gru_a_mask"] = torch.as_tensor(mask)
    params = {k: v.to(device) for k, v in params.items()}
    w = sampler_weights_for(model, params)
    fn = _sampler.sampler_frames if S == 1 else \
        _sampler.sampler_frames_bunched

    def carry0():
        st = net_vocoder_init(model, batch=B, device=device)
        return st.h_a, st.h_b, st.sig_mem, st.exc_idx
    return fn, w, carry0


def run_variant(name: str, mask, frames: int, batch: int, chain: int,
                reps: int, device) -> dict:
    S, sparse = variant(name)
    fn, w, carry0 = _setup(S, sparse, mask, batch, device)
    rng = np.random.default_rng(0)
    T, B = frames, batch
    cond = torch.as_tensor(rng.normal(size=(T, B, 128)) * 0.1,
                           dtype=torch.float32).to(device)
    lpc = torch.as_tensor(rng.normal(size=(T, B, 16)) * 0.01,
                          dtype=torch.float32).to(device)
    temp = torch.full((T, B), 1.5, device=device)
    noise = gumbel_noise(0, 0, T, B, device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else \
        (lambda: None)
    run = lambda c: fn(w, c, cond, lpc, temp, noise)  # noqa: E731

    t0 = time.perf_counter()
    c, sig = run(carry0())
    sync()
    print(f"{name}: first call (builds the kernel, lays out the weights) "
          f"{time.perf_counter() - t0:.1f}s")
    t_single = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        c, sig = run(c)
        sync()
        t_single = min(t_single, time.perf_counter() - t0)
    t_chain = np.inf
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            sync()
            start.record()
            for _ in range(chain):
                c, sig = run(c)
            end.record()
            end.synchronize()
            t_chain = min(t_chain, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(chain):
                c, sig = run(c)
            t_chain = min(t_chain, time.perf_counter() - t0)
    if not bool(torch.isfinite(sig).all()):
        raise AssertionError(f"{name}: non-finite samples")
    audio_s = B * T * FRAME_SIZE / 16000.0
    per_call = t_chain / chain
    out = {"bunch": S, "sparse": sparse, "frames": T, "batch": B,
           "chain": chain, "call_ms": t_single * 1e3,
           "chain_ms_per_call": per_call * 1e3,
           "rtf_call": audio_s / t_single,
           "rtf_device": audio_s / per_call if cuda else None,
           "us_per_sample": 1e6 * per_call / (T * FRAME_SIZE),
           "timed_by": "CUDA events" if cuda else "host clock (CPU)"}
    dev_txt = f"rtf_device={out['rtf_device']:.1f}x" if cuda else \
        "rtf_device=not measured (CPU)"
    print(f"{name}: rtf_call={out['rtf_call']:.1f}x {dev_txt} "
          f"({out['us_per_sample']:.3f} us/sample, {out['timed_by']})")
    return out


def main(argv=None) -> dict:
    """Prints each variant's line and the summary; returns them by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--chain", type=int, default=24)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--variants", type=str, default="")
    ap.add_argument("--ablate", nargs="?", const="sparse-f32", default=None,
                    help="not available: the kernel has no stage switches")
    ap.add_argument("--weights", type=str,
                    default="weights/vocoder_synthetic.npz",
                    help=".npz checkpoint whose gru_a_mask supplies the "
                         "sparse pattern")
    ap.add_argument("--device", default=None,
                    help="Torch device (default: cuda).")
    args = ap.parse_args(argv)
    if args.ablate is not None:
        raise ValueError("--ablate has no counterpart: the CUDA sampler has "
                         "one numeric path and no per-stage switches; "
                         "tools/torch_sampler_cluster_sizes.py times its "
                         "phases through trace points")
    names = [v for v in args.variants.split(",") if v] or \
        ["dense-f32", "sparse-f32"]
    for name in names:
        variant(name)  # every name checked before any work
    device = resolve_device(args.device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"device: {device} ({where})")

    mask = sparse_mask(args.weights, (384, 1152))
    kept, rows = pattern_summary(mask)
    print(f"pattern kept={kept:.3f} rows/group={rows}")
    results = {name: run_variant(name, mask, args.frames, args.batch,
                                 args.chain, args.reps, device)
               for name in names}

    print("\n== summary ==")
    for name, r in results.items():
        dev_txt = f"{r['rtf_device']:7.1f}x device" \
            if r["rtf_device"] is not None else "    not measured"
        print(f"{name:24s} {dev_txt}  {r['us_per_sample']:7.3f} us/sample")
    return results


if __name__ == "__main__":
    main()
