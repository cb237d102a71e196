"""The harness finds cells, configurations, traffic and metrics by name, and
``BENCHMARK.json`` keeps to the contract's static rules."""

import json
import re
import shutil
import subprocess
import sys

from small import ROOT

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _copy_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_a_cell_config_and_metric_are_added_by_new_files_only(tmp_path):
    root = _copy_benchmark(tmp_path)
    bench = root / "benchmark"
    before = {p.relative_to(root): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    # a new configuration, traffic, cell and per-layer metric, as files
    cfg = json.loads((bench / "configs" / "kitti-odometry-street.json").read_text())
    cfg["name"] = "new-config"
    (bench / "configs" / "new-config.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "drive-gicp.json").read_text())
    tr["drive"]["speed_m"] = 0.5
    (bench / "traffic" / "new-traffic.json").write_text(json.dumps(tr))
    shutil.copy(bench / "cells" / "odom-gicp.json", bench / "cells" / "new-cell.json")
    (bench / "metrics" / "new_metric.new.py").write_text(
        '"""A test metric."""\n\n\ndef read(run):\n    return 42.0\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "new-config", "source": "https://example.org/new",
                            "file": "benchmark/configs/new-config.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "new-cell", "config": "new-config",
                              "traffic": "new-traffic", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "new_metric.new", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "a test", "moves": "scan_ms",
                              "workloads": ["new-cell"]})
    for m in spec["end_to_end"]:
        if m["name"] == "scan_ms":
            m["workloads"].append("new-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    # nothing that was there changed but BENCHMARK.json
    after = {p.relative_to(root): p.read_bytes() for p in bench.rglob("*")
             if p.is_file() and p.relative_to(root) in before}
    assert after == before
    run = harness.Run("new-cell", 1, 1.0, True, "cpu", root=root)
    assert run.config["name"] == "new-config"
    assert run.traffic["drive"]["speed_m"] == 0.5
    assert "limits" in run.cell
    e2e = [m["name"] for m in run.spec["end_to_end"] if harness.applies(m, "new-cell")]
    assert e2e == ["scan_ms", "setup_s"]
    layer = [m for m in run.spec["per_layer"]
             if harness.applies(m, "new-cell", set(e2e))]
    assert [m["name"] for m in layer] == ["new_metric.new"]
    reader = harness.load_module(run.bench / "metrics" / "new_metric.new.py", "new_metric.new")
    assert reader.read(run) == 42.0


def test_benchmark_json_keeps_to_the_contract():
    spec = harness.spec_of()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in spec["workloads"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "benchmark" / "cells" / f"{w['name']}.json").is_file()
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in spec["end_to_end"])
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in [e["name"] for e in spec["end_to_end"]]
        assert 1 <= len(m["layer"]) <= 200
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        e2e = {m["name"] for m in spec["end_to_end"] if harness.applies(m, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(harness.applies(m, cell, e2e) for m in spec["per_layer"])


def test_run_refuses_without_a_gpu_and_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "odom-gicp", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_fails_in_a_checkout_without_the_port(tmp_path):
    root = _copy_benchmark(tmp_path)
    out = subprocess.run([sys.executable, str(root / "benchmark" / "run.py"), "--workload",
                          "odom-gicp", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=root, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
