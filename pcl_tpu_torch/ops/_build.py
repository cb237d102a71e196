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

``host_library`` builds a host source (``csrc/<name>.c``: file parsing;
``csrc/<name>.cpp``: C++17 host code; no device code in either) the same way
with the host's compiler (C++ with OpenMP where it links, else without), or
``nvcc -x c`` / ``-x c++`` where there is none; these are not among the
kernel libraries ``build_all`` counts.
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
HOST_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def _host_compilers(lang: str) -> List[List[str]]:
    """The commands that compile host ``lang`` ("c" or "c++"), in the order
    to try them: ``cc``/``gcc`` (``g++``/``c++`` with OpenMP first, then
    without), else nvcc taking the file as C or C++."""
    names, flags = (("cc", "gcc"), HOST_C_FLAGS) if lang == "c" else (("g++", "c++"),
                                                                       HOST_CXX_FLAGS)
    for cc in names:
        found = shutil.which(cc)
        if found:
            return [[found, *flags]] if lang == "c" else [[found, *flags, "-fopenmp"],
                                                          [found, *flags]]
    std = [] if lang == "c" else ["-std=c++17"]
    return [[_nvcc(), "-x", lang, *std, "-O3", "-shared", "-Xcompiler", "-fPIC"]]


def _host_output(name: str, src: Path, cmd: List[str]) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(cmd[1:]).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def host_library(name: str) -> ctypes.CDLL:
    """The loaded library of the host source ``csrc/<name>.c`` or
    ``csrc/<name>.cpp``, built first if needed: the first command of
    ``_host_compilers`` whose library exists, else the first that builds it.
    The file name carries a hash of the source and the command's flags.
    Raises ``RuntimeError`` where the machine has no compiler or no command
    builds it."""
    key = f"host:{name}"
    with _lock:
        lib = _loaded.get(key)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.c"
        lang = "c"
        if not src.exists():
            src, lang = CSRC / f"{name}.cpp", "c++"
        cmds = _host_compilers(lang)
        out = next((o for o in (_host_output(name, src, c) for c in cmds) if o.exists()), None)
        errors = []
        for cmd in cmds if out is None else []:
            target = _host_output(name, src, cmd)
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.parent / f"{target.stem}.{os.getpid()}.tmp"
            done = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                                  capture_output=True, text=True)
            if done.returncode == 0:
                os.replace(tmp, target)
                out = target
                break
            errors.append(f"{' '.join(cmd)} (exit {done.returncode}):\n"
                          f"{done.stdout}{done.stderr}")
        if out is None:
            raise RuntimeError(f"no host compiler built csrc/{src.name}:\n" + "\n".join(errors))
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
