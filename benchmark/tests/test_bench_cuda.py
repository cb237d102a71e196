"""The benchmark on the card: one short run of each cell, which has to come
out correct. Skips where there is no CUDA device; run on the card with
``python3 -m pytest -p no:cacheprovider benchmark/tests/test_bench_cuda.py``."""

import json
import subprocess
import sys

import pytest

from small import ROOT

from benchmark import harness


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")
    return "cuda"


@pytest.mark.parametrize("workload", [w["name"] for w in harness.spec_of()["workloads"]])
def test_a_short_run_on_the_card_is_correct(cuda, workload):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                          "2147483999", "--seconds", "20", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-4000:]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
