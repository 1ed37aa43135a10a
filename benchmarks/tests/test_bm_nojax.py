"""No run loads jax, jaxlib, flax or the JAX package: the harness with
every configuration's and traffic mix's modules is imported in a fresh
process and its modules' top-level names are checked whole."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmarks import common

PROBE = r"""
import json, sys
sys.path.insert(0, ROOT)
from benchmarks import common, checks, run
bench = common.benchmark()
for w in bench["workloads"]:
    entry, config, traffic = common.cell(bench, w["name"])
    common.runner(traffic)
for m in bench["end_to_end"] + bench["per_layer"]:
    common.reader(m["name"])
import benchmarks.reference.lpcnet, benchmarks.reference.dsp
import benchmarks.reference.lpcnet_bunched
import dss_tpu_torch.apps.decode_online, dss_tpu_torch.vocoder.net
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def test_bm_forbidden_names_compared_whole():
    assert common.forbidden_loaded({"dss_tpu_torch.ops": 1}) == []
    assert common.forbidden_loaded({"dss_tpu.ops": 1}) == ["dss_tpu"]
    assert common.forbidden_loaded({"jax": 1, "jaxlib.x": 1}) == \
        ["jax", "jaxlib"]


def test_bm_harness_loads_no_jax():
    code = PROBE.replace("ROOT", repr(str(common.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=common.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "benchmarks" in tops and "dss_tpu_torch" in tops
    assert not tops & set(common.FORBIDDEN), tops & set(common.FORBIDDEN)
