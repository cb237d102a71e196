"""The port stands alone: no module of pcl_tpu_torch, and not chip_smoke.py,
imports JAX or the JAX package; the constructors that pick a device ask for
CUDA unless told otherwise; chip_smoke.py refuses to run without a card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pcl_tpu_torch import interop
from pcl_tpu_torch.core import cloud as tcloud

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "pcl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pcl_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_pcl_tpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom pcl_tpu.core import cloud\n"
                 "import pcl_tpu_torch\nimport importlib\nimportlib.import_module('pcl_tpu.x')\n")
    assert [m for m in _imported_modules(f) if _forbidden(m)] == \
        ["jax.numpy", "pcl_tpu.core", "pcl_tpu.x"]


@pytest.mark.parametrize("make", [
    lambda: tcloud.make_cloud(np.zeros((4, 3), np.float32)),
    lambda: tcloud.from_numpy(np.zeros((4, 3), np.float32)),
    lambda: interop.cloud_from_arrays(np.zeros((4, 3), np.float32), np.ones(4, bool)),
], ids=["make_cloud", "from_numpy", "cloud_from_arrays"])
def test_default_device_is_cuda(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_cuda_is_what_none_asks_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tcloud._device(None) == torch.device("cuda")
    assert tcloud._device("cpu") == torch.device("cpu")
    c = tcloud.make_cloud(np.ones((3, 3)), device="cpu")
    assert c.xyz.device.type == "cpu" and c.xyz.dtype == torch.float32


def _run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
