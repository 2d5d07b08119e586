"""Builds the port's CUDA sources (csrc/*.cu) into shared libraries.

Each source is compiled by `nvcc` for Hopper (sm_90a) into a library
with a plain C interface, which the kernel wrappers load with ctypes.
Nothing is built when the package is imported: a wrapper builds its
library at its first CUDA call, and `build()` builds several at once,
one nvcc process per source, all started together.

Libraries go to `arrow_go_tpu_torch/build/` (ignored by git), named by
a hash of the source and the flags, so a changed source rebuilds and an
unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_scratch: Dict[tuple, torch.Tensor] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built on this machine")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names: Sequence[str]) -> float:
    """Compile the named sources that have no current library, all in
    parallel. Returns the seconds spent; raises with nvcc's output if a
    compile fails. ptxas's register report lands beside each library
    (`<lib>.log`)."""
    t0 = time.perf_counter()
    todo = [(n, library_path(n)) for n in names
            if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        text = log.decode(errors="replace")
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exit {p.returncode}\n{text}")
            continue
        out.with_name(out.name + ".log").write_text(text)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_scratch(name: str, device: torch.device, stream: int,
                   words: int) -> torch.Tensor:
    """`words` int64 of zeroed scratch for kernel `name` on one device
    and stream, allocated at first use and kept. A kernel leaves it as it
    found it (its last block resets its ticket), so no call pays a fill,
    and two streams never share a ticket."""
    key = (name, device.index, stream)
    if key not in _scratch:
        _scratch[key] = torch.zeros(words, dtype=torch.int64, device=device)
    return _scratch[key]
