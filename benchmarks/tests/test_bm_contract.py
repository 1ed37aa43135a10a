"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file: configurations, traffic mixes, their runners, one reader
per metric, a limit per compared number.

    python -m pytest benchmarks/tests -q
"""

from __future__ import annotations

import json
import re

import pytest

from benchmarks import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return common.benchmark()


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_bm_top_level(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "benchmarks/run.py"]
    assert bench["paths"] == ["benchmarks"]
    assert 1 <= bench["run_seconds"] <= 51
    raw = (common.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024


def test_bm_full_check_fits_with_24_cells(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_bm_configs(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmarks/")
        conf = common.load_json(common.ROOT / c["file"])
        assert conf["name"] == c["name"]
        assert c["reduced"] == []
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in bench["workloads"]}
    assert used == names


def test_bm_workloads(bench):
    pairs, names = set(), set()
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in names
        names.add(w["name"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        entry, config, traffic = common.cell(bench, w["name"])
        assert (common.HERE / "runners" / f"{traffic['runner']}.py").exists()


def test_bm_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert (common.HERE / "metrics" / f"{m['name']}.py").exists()
        assert hasattr(common.reader(m["name"]), "read")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e and m["workloads"]
        if m["name"].startswith(("roofline.", "mfu.")) or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_bm_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in common.metrics_of(bench, w["name"],
                                                    "end_to_end")]
        per = common.metrics_of(bench, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:   # a per-layer metric moves what its cells report
            assert m["moves"] in e2e
        moved = {m["moves"] for m in per if m["name"].startswith("roofline")}
        mfu = {m["moves"] for m in per if "mfu" in m["name"]}
        assert moved <= mfu


def test_bm_limits_cover_every_number():
    limits = common.load_json(common.HERE / "limits.json")["limits"]
    for name in ("features_gap", "decoder_gap", "audio_gap_lsb",
                 "state_gap", "sampler_disagree", "pred_gap"):
        assert limits[name]["limit"] > 0


def test_bm_names_of_files():
    ok = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for p in common.HERE.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert ok.match(str(p.relative_to(common.ROOT))), p


def test_bm_result_line_shape():
    """The keys a result line carries, and the checks key last."""
    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
            "device": {}, "checks": common.checks_line({"a": (1.0, 2.0)})}
    assert list(json.loads(json.dumps(line)))[-1] == "checks"
