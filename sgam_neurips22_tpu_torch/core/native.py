"""Build the port's host-side C++ sources with g++, at first use.

Each source is compiled alone, with the flags of the repository's
`native/Makefile`, into `build/` beside this package (listed in
.gitignore), under a file name that carries a hash of the source and the
flags, so an edited source is rebuilt. Nothing here runs at import time,
and nothing is written beside the sources.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from sgam_neurips22_tpu_torch.ops.cuda_build import BUILD_DIR

CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]


def lib_path(source: Path, stem: str) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{stem}-{digest}.so"


def build(source: Path, stem: str) -> Path:
    """The shared library of `source`, compiled unless it exists; raises
    with the compiler's output if the build fails."""
    out = lib_path(source, stem)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"g++ not found (set CXX); {source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{source.name} build failed ({cxx} exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
