"""One run of one benchmark cell on the card.

    python benchmarks/run.py --workload CELL --seed N --seconds S --trace 0|1

The cell's entry in BENCHMARK.json names its configuration (its file) and
its traffic mix (benchmarks/traffic/<mix>.json), which names the general
runner (benchmarks/runners/<runner>.py) that sets up the program, runs the
window and checks what it produced.  The metrics are read by one reader a
metric (benchmarks/metrics/<name>.py): the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1`` (the window under
the device profiler).

The last line of standard output is the result as one JSON object; the
numbers compared with the reference close standard error, each beside its
limit.  Exit codes: 2, no card (or too few); 3, a forbidden module (jax,
jaxlib, flax, dss_tpu) was loaded; 4, an end-to-end metric had nothing to
read.  ``--control 1`` puts the bfloat16 control in the program's place,
one stage at a time, after the window: ``correct`` is then the control's
(false unless every stage passes), each stage's numbers under
``control``; the program's own stay under ``checks``.  The limits are set
from both; the benchmark's own runs do not pass it."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One thread a pool: the program's host work is small Python-driven
# launches, and idle pool threads spinning beside them only add jitter.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common  # noqa: E402
from benchmarks.trace import DeviceTrace  # noqa: E402

CACHE = ROOT / ".bench_cache"


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its kernels under dss_tpu_torch/_build/ itself)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def verdict(numbers) -> bool:
    return all(v <= lim for v, lim in numbers.values())


def print_checks(numbers, prefix="") -> None:
    for name, (value, limit) in numbers.items():
        print(f"{prefix}check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)


def main(argv=None, device=None) -> int:
    """``device`` None: the card, required; a test passes "cpu"."""
    args = parse(argv)
    fixed_caches()
    bench = common.benchmark()
    entry, config, traffic = common.cell(bench, args.workload)
    import torch
    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    run_dir = Path(tempfile.gettempdir()) / "dss_bench" / args.workload
    ctx = dict(args=args, bench=bench, entry=entry, config=config,
               traffic=traffic, device=device, t_start=T_START,
               run_dir=str(run_dir),
               trace=DeviceTrace(str(run_dir)) if args.trace else None)
    try:
        rec = common.runner(traffic).run(ctx)
    finally:
        if ctx["trace"] is not None:
            ctx["trace"].close()
        shutil.rmtree(run_dir, ignore_errors=True)
    bad = common.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in common.metrics_of(bench, args.workload, kind):
        value = common.reader(m["name"]).read(rec, ctx)
        if value is None:
            if kind == "end_to_end":
                print(f"{m['name']}: nothing to read", file=sys.stderr)
                return 4
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = rec["checks"]
    correct = verdict(checks)
    control = rec.get("control")
    if control is not None:
        correct = all(verdict(v) for v in control.values())
    dev = dict(platform="gpu" if device == "cuda" else device,
               kind=(torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
               count=entry["chips"],
               memory_peak_bytes=rec.get("memory_peak_bytes") or 0)
    if device == "cuda":
        dev["power_limit_w"] = power_limit()
    line = dict(correct=correct, attempted=rec["attempted"],
                failed=rec["failed"], metrics=metrics, device=dev)
    if rec.get("trace"):
        t = rec["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = dict(device_ops=t["device_ops"],
                                 idle_gaps=t["idle_gaps"])
    line["check_s"] = rec["check_s"]
    if control is not None:
        line["control"] = {k: dict(correct=verdict(v),
                                   checks=common.checks_line(v))
                           for k, v in control.items()}
    line["checks"] = common.checks_line(checks)
    print(json.dumps(line), flush=True)
    for stage, numbers in (control or {}).items():
        print_checks(numbers, f"control {stage} ")
    print_checks(checks)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
