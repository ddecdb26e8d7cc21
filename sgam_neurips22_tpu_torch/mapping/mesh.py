"""Triangle meshes of the TSDF map — port of
`sgam_neurips22_tpu/mapping/mesh.py`. The extractor is the repository's
native C++ marching-tetrahedra source, `native/mesh_extract.cpp`, called
through ctypes; mesh export is host-side work after the unroll.

The port builds that one source with g++ at first use (`core.native`, with
native/Makefile's flags, so that the soup equals the JAX package's) and
loads it only if its ABI version is the one this binding was written for.
Nothing here runs at import time, and nothing is written into `native/`.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from sgam_neurips22_tpu_torch.core import native
from sgam_neurips22_tpu_torch.ops.cuda_build import BUILD_DIR, PACKAGE  # noqa: F401  (BUILD_DIR: where lib_path lies)

SOURCE = PACKAGE.parent / "native" / "mesh_extract.cpp"
ABI_VERSION = 4  # native sgam_native_abi_version() this binding calls through
_F32P = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    return native.lib_path(SOURCE, "libsgam_mesh")


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE, "libsgam_mesh")))
            lib.sgam_native_abi_version.restype = ctypes.c_int32
            got = lib.sgam_native_abi_version()
            if got != ABI_VERSION:
                raise RuntimeError(f"{SOURCE} has ABI {got}; this binding calls ABI {ABI_VERSION}")
            lib.tsdf_extract_mesh.restype = ctypes.c_int64
            lib.tsdf_extract_mesh.argtypes = [
                _F32P, _F32P, _F32P,  # tsdf, weight, color
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # dims
                ctypes.c_float, ctypes.c_float, ctypes.c_float,  # origin
                ctypes.c_float, ctypes.c_float,  # voxel, iso
                _F32P, _F32P,  # out verts, out colours
                ctypes.c_int64, ctypes.c_int32,  # max triangles, has_color
            ]
            _lib = lib
        return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def extract_mesh(volume, cfg, iso: float = 0.0, color_grid: Optional[np.ndarray] = None,
                 max_triangles: int = 25_000_000) -> Tuple[np.ndarray, np.ndarray]:
    """A one-scene volume -> triangle soup (vertices [T, 3, 3], colours
    [T, 3, 3]) of its iso-surface over the observed voxels.

    Args:
      volume: mapping.tsdf.TSDFVolume of one scene; cfg: its TSDFConfig.
      color_grid: [X, Y, Z, 3] per-voxel colours; gray where absent.
      max_triangles: at most this many triangles are returned (random
        weights can put a crossing in nearly every observed voxel); a
        larger surface is cut, with a warning printed.
    """
    lib = _load()
    tsdf = np.ascontiguousarray(volume.tsdf.cpu().numpy(), np.float32)
    weight = np.ascontiguousarray(volume.weight.cpu().numpy(), np.float32)
    if tsdf.size != cfg.n_voxels:
        raise ValueError(f"extract_mesh takes a one-scene volume; this one holds {tsdf.size // cfg.n_voxels}")
    # the flat arrays are laid out per axis_order: hand the extractor the
    # layout's dims and origin, and put the vertex axes back afterwards
    order = tuple(cfg.axis_order)
    has_color = color_grid is not None
    color = (np.ascontiguousarray(np.transpose(np.asarray(color_grid), order + (3,)), np.float32) if has_color
             else np.zeros(1, np.float32))
    x, y, z = (cfg.dims[a] for a in order)
    ox, oy, oz = (cfg.origin[a] for a in order)
    empty = np.zeros(1, np.float32)

    def run(verts, cols, cap):
        return lib.tsdf_extract_mesh(_fp(tsdf), _fp(weight), _fp(color), x, y, z, ox, oy, oz, cfg.voxel_size, iso,
                                     _fp(verts), _fp(cols), cap, int(has_color))

    n = run(empty, empty, 0)
    if n == 0:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0, 3, 3), np.float32)
    if n > max_triangles:
        print(f"WARNING: mesh extraction found {n} triangles; writing the first {max_triangles} "
              "(raise max_triangles to keep all)")
        n = max_triangles
    verts, cols = np.empty((n, 3, 3), np.float32), np.empty((n, 3, 3), np.float32)
    if run(verts, cols, n) < n:
        raise RuntimeError("mesh extraction returned fewer triangles on its second pass")
    if order != (0, 1, 2):
        verts = np.ascontiguousarray(verts[..., np.argsort(order)])
    return verts, cols


def write_mesh_ply(path: str, verts: np.ndarray, cols: np.ndarray) -> None:
    """Triangle soup -> binary PLY with vertex colours and face indices."""
    t = len(verts)
    header = [
        "ply", "format binary_little_endian 1.0", f"element vertex {3 * t}",
        "property float x", "property float y", "property float z",
        "property uchar red", "property uchar green", "property uchar blue",
        f"element face {t}", "property list uchar int vertex_indices", "end_header", "",
    ]
    vrec = np.zeros(3 * t, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    vrec["xyz"] = verts.reshape(-1, 3)
    vrec["rgb"] = np.clip(cols.reshape(-1, 3) * 255.0, 0, 255).astype(np.uint8)
    frec = np.zeros(t, dtype=[("n", "u1"), ("idx", "<i4", 3)])
    frec["n"] = 3
    frec["idx"] = np.arange(3 * t, dtype="<i4").reshape(t, 3)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode())
        f.write(vrec.tobytes())
        f.write(frec.tobytes())
