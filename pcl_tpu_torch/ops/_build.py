"""Builds the CUDA sources in ``pcl_tpu_torch/csrc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into its own
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

``build/`` sits at the root of the checkout (``.gitignore`` lists it). The file
name carries a hash of the source and the flags, so an edited source is built
anew and an unchanged one is loaded as it is. ``nvcc``'s output (with
``-Xptxas -v``: registers, shared memory and spills per kernel) is kept beside
the library as ``<name>-<hash>.log``. A failed build raises; nothing falls back
to the plain PyTorch versions.

``host_library`` builds a host C source (``csrc/<name>.c``: file parsing, no
device code) the same way with the host's C compiler, or ``nvcc -x c`` where
there is none; these are not among the kernel libraries ``build_all`` counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of pcl_tpu_torch are "
                       "built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    process (or None) and the library path."""
    out = library_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.stem}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return (proc, tmp), out


def _finish(name: str, started, out: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or nothing


def build(names: Iterable[str]) -> List[Path]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together. Returns the library paths."""
    names = list(names)
    with _lock:
        jobs = [(n, *_start(n)) for n in names]
        for n, started, out in jobs:
            _finish(n, started, out)
    return [out for _, _, out in jobs]


def build_all() -> List[Path]:
    return build(sorted(p.stem for p in CSRC.glob("*.cu")))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        with _lock:
            _loaded[name] = lib
    return lib


HOST_C_FLAGS = ["-O3", "-shared", "-fPIC"]


def _host_compiler() -> List[str]:
    """The command that compiles host C: ``cc`` or ``gcc``, else nvcc taking
    the file as C."""
    for cc in ("cc", "gcc"):
        found = shutil.which(cc)
        if found:
            return [found, *HOST_C_FLAGS]
    return [_nvcc(), "-x", "c", "-O3", "-shared", "-Xcompiler", "-fPIC"]


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of the host C source ``csrc/<name>.c``, built first
    if needed. Raises ``RuntimeError`` where the machine has no compiler or
    the build fails."""
    key = f"{name}.c"
    with _lock:
        lib = _loaded.get(key)
        if lib is not None:
            return lib
        src = CSRC / key
        cmd = _host_compiler()
        digest = hashlib.sha256(src.read_bytes() + " ".join(cmd[1:]).encode())
        out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.parent / f"{out.stem}.{os.getpid()}.tmp"
            done = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"{cmd[0]} failed for csrc/{key} (exit "
                                   f"{done.returncode}):\n{done.stdout}{done.stderr}")
            os.replace(tmp, out)
        lib = _loaded[key] = ctypes.CDLL(str(out))
    return lib


_SAME_DEVICE = contextlib.nullcontext()


def on_device(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device: nothing to
    enter when it already is (the usual case on a wrapper's hot path)."""
    if dev.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(dev)


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(dev: torch.device) -> int:
    """The ``cudaStream_t`` of PyTorch's current stream on ``dev`` as an
    int, without building a ``torch.cuda.Stream`` where PyTorch offers the
    raw pointer (the object costs several microseconds per call)."""
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def build_log(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
