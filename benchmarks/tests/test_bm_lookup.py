"""Cells, configurations, traffic mixes, runners and metric readers are
found by name, so a new configuration, traffic mix or per-layer metric is
new files under benchmarks/ and new entries in BENCHMARK.json, with no
file edited: shown on a copy of the benchmark with a dummy of each, run on
the CPU in a process of its own."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmarks import common


def test_bm_lookup_by_name():
    bench = common.benchmark()
    entry, config, traffic = common.cell(bench, "b1_serve15")
    assert config["name"] == "lpcnet_b1" and traffic["runner"] == "serve"
    assert common.runner(traffic).__name__.endswith("serve")
    per = [m["name"] for m in common.metrics_of(bench, "b1_serve15",
                                                "per_layer")]
    assert "roofline.k2.serve" in per and "roofline.frontend" not in per
    per = [m["name"] for m in common.metrics_of(bench, "b8_session",
                                                "per_layer")]
    assert "roofline.k3.word" in per and "roofline.k2.word" not in per
    entry, config, traffic = common.cell(bench, "b8_session")
    assert config["vocoder"]["bunch"] == 8 and traffic["runner"] == "session"
    e2e = [m["name"] for m in common.metrics_of(bench, "dsp_session",
                                                "end_to_end")]
    assert e2e == ["first_audio_ms_p50", "packet_step_ms_p50", "setup_s"]


DUMMY_METRIC = '''"""Serving steps in the window (a dummy per-layer metric)."""


def read(rec, ctx):
    return float(rec["steps"]) if rec["kind"] == "serve" else None
'''


def test_bm_dummy_entries_need_only_new_files(tmp_path):
    tree = tmp_path / "tree"
    shutil.copytree(common.HERE, tree / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(common.ROOT / "weights", tree / "weights")
    bench = common.benchmark()
    # New files only.
    conf = common.load_json(common.HERE / "configs" / "lpcnet_b1.json")
    conf["name"] = "lpcnet_dummy"
    (tree / "benchmarks/configs/lpcnet_dummy.json").write_text(
        json.dumps(conf))
    (tree / "benchmarks/traffic/serve_dummy.json").write_text(json.dumps(
        {"runner": "serve", "streams": 2, "frames": 10,
         "feature_scale": 0.3, "c0_offset": -2.0, "pool": 2}))
    (tree / "benchmarks/metrics/dummy.steps.py").write_text(DUMMY_METRIC)
    # New entries only.
    bench["configs"].append(dict(bench["configs"][1], name="lpcnet_dummy",
                                 file="benchmarks/configs/lpcnet_dummy.json"))
    bench["workloads"].append(dict(name="dummy_serve", config="lpcnet_dummy",
                                   traffic="serve_dummy", chips=1, why="x"))
    bench["per_layer"].append(dict(
        name="dummy.steps", unit="steps", better="higher",
        source="program_counter", layer="vocoder/net.py",
        moves="audio_s_per_s", workloads=["dummy_serve"]))
    next(m for m in bench["end_to_end"]
         if m["name"] == "audio_s_per_s")["workloads"].append("dummy_serve")
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys; sys.path.insert(0, {str(tree)!r}); "
            f"from benchmarks import run; "
            f"sys.exit(run.main(sys.argv[1:], device='cpu'))")
    env = dict(os.environ, PYTHONPATH=str(common.ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code, "--workload", "dummy_serve", "--seed",
         "12", "--seconds", "1", "--trace", "1"], capture_output=True,
        text=True, timeout=600, cwd=tree, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["dummy.steps"]["value"] >= 1
    for p in common.HERE.rglob("*"):   # every old file as it was
        if p.is_file() and "__pycache__" not in p.parts:
            copy = tree / "benchmarks" / p.relative_to(common.HERE)
            assert copy.read_bytes() == p.read_bytes(), p
