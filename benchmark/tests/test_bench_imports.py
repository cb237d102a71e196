"""What the benchmark loads: nothing of JAX or of the JAX package in a run,
nothing of the port in the reference. Top-level module names are compared
whole (``pcl_tpu_torch`` is not ``pcl_tpu``)."""

import json
import subprocess
import sys

from small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pcl_tpu"}

_RUN = r"""
import json, sys
sys.path.insert(0, %(root)r)
from benchmark import harness, run
spec = harness.spec_of()
for w in spec["workloads"]:
    tr = harness.load_json(harness.BENCH / "traffic" / (w["traffic"] + ".json"))
    harness.load_module(harness.BENCH / "drivers" / (tr["driver"] + ".py"), tr["driver"])
for m in spec["end_to_end"] + spec["per_layer"]:
    harness.load_module(harness.BENCH / "metrics" / (m["name"] + ".py"), m["name"])
import pcl_tpu_torch
from pcl_tpu_torch import filters, registration, search
from pcl_tpu_torch.tools import odometry
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

_REFERENCE = r"""
import json, sys
sys.path.insert(0, %(root)r)
import benchmark.reference.search, benchmark.reference.geometry
import benchmark.scenes.street
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code % {"root": str(ROOT)}],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    loaded = _top_level(_RUN)
    assert "pcl_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level(_REFERENCE)
    assert not loaded & (FORBIDDEN | {"pcl_tpu_torch"})


def test_the_reference_sources_name_no_port_module():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in FORBIDDEN | {"pcl_tpu_torch"}, (path, line)
