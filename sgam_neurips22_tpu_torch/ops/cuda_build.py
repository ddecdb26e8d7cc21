"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface, at first use, into `build/` beside this
package (listed in .gitignore), and loaded with ctypes. The library's file
name carries a hash of its source, the `csrc/*.cuh` headers it includes
and the flags, so an edited source or header is rebuilt, and a header edit
rebuilds only the kernels that include it. Nothing here runs at import
time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = sorted(set(re.findall(rb'^#include "(\w+\.cuh)"', src, re.M)))
    text = b"".join([src, *((CSRC / h.decode()).read_bytes() for h in headers)])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, str]:
    """Compile every named kernel whose library is missing, one `nvcc` per
    source, all started together. Returns {name: nvcc's ptxas report}
    for the ones built; raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel `name` (built first if needed), with
    each C entry point's argtypes set from `signatures` and restype int
    (a cudaError_t)."""
    with _lock:
        if name not in _loaded:
            build(name)
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")

