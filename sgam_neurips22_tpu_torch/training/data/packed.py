"""Packed RGB-D shards with native (C++) batch assembly — port of
`sgam_neurips22_tpu/training/data/packed.py`.

A shard holds each record's post-resize uint8 RGB and a float32 channel
(the final disparity of a codebook shard, or the metric depth of a
pair-dataset frame store), decoded once at pack time; the repository's
`native/packed_loader.cpp` assembles float32 NHWC batches from it in C++
threads, called as it is through ctypes. Batches equal `CodebookDataset`'s
bit for bit (the assembler applies the same `v / 127.5 - 1` float32 ops).
The JAX package's `tools/pack_dataset.py` writes shards in this format,
and so do `ShardWriter` and `write_shard` here.
"""
from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np

from sgam_neurips22_tpu_torch.core import native
from sgam_neurips22_tpu_torch.ops.cuda_build import PACKAGE

SOURCE = PACKAGE.parent / "native" / "packed_loader.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

MAGIC = b"SGPKv01\x00"
HEADER = np.dtype(
    [("magic", "S8"), ("n", "<u4"), ("h", "<u4"), ("w", "<u4"), ("flags", "<u4")]
)


def shard_path(dataset_dir: str, split: str, resolution) -> str:
    h, w = resolution
    return os.path.join(dataset_dir, f"{split}_{h}x{w}.sgpk")


class ShardWriter:
    """Streaming shard writer: O(1) host memory, any dataset size.

    Records append one at a time; `close()` back-patches the record count
    into the header and atomically renames the temp file into place (a
    crashed pack never leaves a readable half-shard: the temp header holds
    n=0 until close, and sgpk_open rejects n == 0)."""

    def __init__(self, path: str, has_depth: bool, raw_depth: bool = False):
        self.path = path
        self.has_depth = has_depth
        self.raw_depth = raw_depth
        self.hw = None
        self.n = 0
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._f.write(b"\x00" * HEADER.itemsize)  # placeholder header

    def add(self, rgb_u8: np.ndarray, channel: np.ndarray | None = None) -> None:
        rgb = np.ascontiguousarray(rgb_u8, np.uint8)
        if rgb.ndim != 3 or rgb.shape[2] != 3:
            raise ValueError(f"record {self.n} rgb shape {rgb.shape} != (H, W, 3)")
        if self.hw is None:
            self.hw = rgb.shape[:2]
        if rgb.shape[:2] != self.hw:
            raise ValueError(f"record {self.n} rgb shape {rgb.shape} != {self.hw}")
        self._f.write(rgb.tobytes())
        if self.has_depth:
            if channel is None:
                raise ValueError("has_depth shard needs a float channel per record")
            d = np.ascontiguousarray(channel, "<f4")
            if d.shape != self.hw:
                raise ValueError(f"record {self.n} channel shape {d.shape} != {self.hw}")
            self._f.write(d.tobytes())
        self.n += 1

    def close(self) -> None:
        if self._f is None:
            return
        if self.n == 0 or self.hw is None:
            self._f.close()
            os.remove(self._tmp)
            self._f = None
            raise ValueError("empty shard")
        hdr = np.zeros((), HEADER)
        hdr["magic"] = MAGIC
        hdr["n"], (hdr["h"], hdr["w"]) = self.n, self.hw
        hdr["flags"] = (1 if self.has_depth else 0) | (2 if self.raw_depth else 0)
        self._f.seek(0)
        self._f.write(hdr.tobytes())
        self._f.close()
        self._f = None
        os.replace(self._tmp, self.path)  # atomic


def write_shard(
    path: str,
    rgb_u8: Sequence[np.ndarray],
    disparity: Sequence[np.ndarray] | None,
    raw_depth: bool = False,
) -> None:
    """Write a shard from in-memory per-record arrays (rgb [H,W,3] u8;
    disparity [H,W] f32 or None for RGB-only) — convenience wrapper over
    ShardWriter for small shards/tests. raw_depth marks the float channel
    as metric depth (pair-dataset frame stores) rather than encoded
    disparity (codebook shards) — readers check the flag so the two cannot
    be confused."""
    has_depth = disparity is not None
    wr = ShardWriter(path, has_depth=has_depth, raw_depth=raw_depth)
    for i in range(len(rgb_u8)):
        wr.add(rgb_u8[i], disparity[i] if has_depth else None)
    wr.close()


SYMBOLS = ("sgpk_open", "sgpk_close", "sgpk_count", "sgpk_height", "sgpk_width", "sgpk_channels", "sgpk_assemble",
           "sgpk_gather")


def load_lib() -> ctypes.CDLL:
    """The shard reader: `native/packed_loader.cpp` built alone with g++ at
    first use (`core.native`) and bound. That source carries no ABI
    version (the JAX package's one library takes it from
    `mesh_extract.cpp`), so the binding checks that each symbol it binds
    is there."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE, "libsgam_packed")))
            missing = [s for s in SYMBOLS if not hasattr(lib, s)]
            if missing:
                raise RuntimeError(f"{SOURCE} lacks {missing}; this binding calls {list(SYMBOLS)}")
            _lib = _bind(lib)
        return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sgpk_open.restype = ctypes.c_void_p
    lib.sgpk_open.argtypes = [ctypes.c_char_p]
    lib.sgpk_close.argtypes = [ctypes.c_void_p]
    for f in (lib.sgpk_count, lib.sgpk_height, lib.sgpk_width, lib.sgpk_channels):
        f.restype = ctypes.c_int64
        f.argtypes = [ctypes.c_void_p]
    lib.sgpk_assemble.restype = ctypes.c_int32
    lib.sgpk_assemble.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
    ]
    lib.sgpk_gather.restype = ctypes.c_int32
    lib.sgpk_gather.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int32,
    ]
    return lib


def read_flags(path: str) -> int:
    hdr = np.fromfile(path, dtype=HEADER, count=1)
    # numpy S8 scalars strip trailing NULs — compare against the stripped magic
    if len(hdr) != 1 or bytes(hdr[0]["magic"]) != MAGIC.rstrip(b"\x00"):
        raise OSError(f"not an SGPK shard: {path}")
    return int(hdr[0]["flags"])


class PackedCodebookDataset:
    """Codebook-phase dataset over a packed shard. Implements the standard
    per-example protocol AND `assemble_batch`, which the Loader prefers:
    one C++ call builds the whole [B, H, W, C] float32 batch."""

    def __init__(self, path: str, threads: int = 0):
        if read_flags(path) & 2:
            raise OSError(
                f"{path} is a raw-depth frame store, not a codebook shard"
            )
        self._lib = load_lib()
        self._h = self._lib.sgpk_open(path.encode())
        if not self._h:
            raise OSError(f"not a readable SGPK shard: {path}")
        self.path = path
        self.threads = threads
        self.height = int(self._lib.sgpk_height(self._h))
        self.width = int(self._lib.sgpk_width(self._h))
        self.channels = int(self._lib.sgpk_channels(self._h))
        self._n = int(self._lib.sgpk_count(self._h))

    def __len__(self) -> int:
        return self._n

    def assemble_batch(self, idxs) -> Dict[str, np.ndarray]:
        idx = np.ascontiguousarray(idxs, np.int64)
        out = np.empty(
            (len(idx), self.height, self.width, self.channels), np.float32
        )
        rc = self._lib.sgpk_assemble(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.threads,
        )
        if rc != 0:
            raise IndexError(f"shard index out of range (n={self._n}): {idxs}")
        return {"image": out}

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {"image": self.assemble_batch([i])["image"][0]}

    def close(self) -> None:
        if self._h:
            self._lib.sgpk_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def frame_store_path(dataset_dir: str, split: str, resolution) -> str:
    h, w = resolution
    return os.path.join(dataset_dir, f"{split}_frames_{h}x{w}.sgpk")


class PackedFrameStore:
    """Frame-level store for the pair datasets: RGB (u8, post-resize) +
    metric depth (f32, post ray->z) per frame, gathered into separate f32
    arrays by C++ threads. A JSON sidecar maps '<scene>/<im_XXXXX.png>' to
    record ids; pose-graph sampling and the relative-transform math stay in
    Python (they are microseconds — the decode was the cost)."""

    def __init__(self, path: str, threads: int = 0):
        flags = read_flags(path)
        if not (flags & 1) or not (flags & 2):
            raise OSError(f"{path} is not a raw-depth frame store")
        self._lib = load_lib()
        self._h = self._lib.sgpk_open(path.encode())
        if not self._h:
            raise OSError(f"not a readable SGPK shard: {path}")
        self.path = path
        self.threads = threads
        self.height = int(self._lib.sgpk_height(self._h))
        self.width = int(self._lib.sgpk_width(self._h))
        with open(path + ".idx.json") as f:
            self.index: Dict[str, int] = json.load(f)

    @staticmethod
    def key_for(rgb_path: str) -> str:
        parts = rgb_path.replace("\\", "/").split("/")
        return "/".join(parts[-2:])

    def record_id(self, rgb_path: str):
        return self.index.get(self.key_for(rgb_path))

    def covers(self, rgb_paths) -> bool:
        return all(self.record_id(p) is not None for p in rgb_paths)

    def gather(self, record_ids):
        """-> (rgb [n, H, W, 3] f32 in [-1,1], depth [n, H, W] f32)."""
        idx = np.ascontiguousarray(record_ids, np.int64)
        n = len(idx)
        rgb = np.empty((n, self.height, self.width, 3), np.float32)
        depth = np.empty((n, self.height, self.width), np.float32)
        rc = self._lib.sgpk_gather(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.threads,
        )
        if rc != 0:
            raise IndexError(f"frame-store gather failed (rc={rc}): {record_ids}")
        return rgb, depth

    def close(self) -> None:
        if self._h:
            self._lib.sgpk_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def pack_pair_frames(ds, out_path: str) -> None:
    """Pack every pose-graph frame of a pair dataset into a raw-depth frame
    store and its JSON index (keyed '<scene>/<im_XXXXX.png>'), as the JAX
    package's tools/pack_dataset.py does: RGB as the loader's uint8, depth
    through the dataset's own `_load_depth` without the source-only
    sentinel replacement (applied at gather time)."""
    from sgam_neurips22_tpu_torch.training.data.io import load_rgb_u8

    index = {}
    nodes = [g.nodes[k] for g in ds.graphs for k in sorted(g.nodes)]
    wr = ShardWriter(out_path, has_depth=True, raw_depth=True)
    for i, node in enumerate(nodes):
        wr.add(load_rgb_u8(node["rgb_path"], ds.image_resolution), ds._load_depth(node["depth_path"], is_dst=True))
        index[PackedFrameStore.key_for(node["rgb_path"])] = i
    wr.close()
    with open(out_path + ".idx.json", "w") as f:
        json.dump(index, f)
