"""What every part of the benchmark shares: where the repository and the
benchmark's files are, how a cell's configuration, traffic mix, runner and
metrics are found by name, the statistics, and the checks of a run's
environment (the card, the modules it may not load)."""

from __future__ import annotations

import functools
import importlib.util
import json
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dss_tpu")
SENTINEL = 1e9   # a compared number where the outputs cannot be lined up


def load_json(path) -> dict:
    with open(path) as fd:
        return json.load(fd)


def benchmark(path: Optional[Path] = None) -> dict:
    return load_json(path or ROOT / "BENCHMARK.json")


def load_module(path: Path, name: Optional[str] = None):
    """Import the Python file ``path`` under a name of its own."""
    name = name or "bench_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(bench: dict, workload: str) -> Tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of a cell, each found
    by its name: the configuration's ``file`` and
    ``benchmarks/traffic/<traffic>.json``."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    return entry, config, traffic


def runner(traffic: dict):
    """The general runner a traffic mix names: benchmarks/runners/<r>.py."""
    return load_module(HERE / "runners" / f"{traffic['runner']}.py")


def metrics_of(bench: dict, workload: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` (end_to_end or per_layer) a cell reports:
    an end-to-end metric with no ``workloads`` is every cell's; a per-layer
    metric is reported in the cells its ``workloads`` lists."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def reader(name: str):
    """The reader of metric ``name``: benchmarks/metrics/<name>.py."""
    return load_module(HERE / "metrics" / f"{name}.py")


def pct(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile, linear between order statistics (numpy's
    default); None for no values."""
    v = np.asarray(list(values), float)
    return float(np.percentile(v, q)) if v.size else None


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names of loaded modules that a run may not load, compared
    whole (``dss_tpu_torch`` is not ``dss_tpu``)."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".")[0] for name in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def checks_line(checks: Dict[str, Tuple[float, float]]) -> dict:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}


class Probes:
    """Wrappers around module functions that record each call."""

    def __init__(self):
        self.calls = {}
        self._saved = []

    def wrap(self, module, name, record):
        orig = getattr(module, name)
        calls = self.calls.setdefault(name, [])

        @functools.wraps(orig)   # and its counters (``launches``)
        def probe(*args, **kw):
            out = orig(*args, **kw)
            calls.append(record(args, kw, out))
            return out
        setattr(module, name, probe)
        self._saved.append((module, name, orig))

    def restore(self):
        for module, name, orig in reversed(self._saved):
            setattr(module, name, orig)
        self._saved.clear()
