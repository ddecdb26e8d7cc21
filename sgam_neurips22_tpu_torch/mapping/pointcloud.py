"""Point clouds of generated frames and their PLY files — port of
`sgam_neurips22_tpu/mapping/pointcloud.py`: per-frame unprojection to
coloured world points, a dependency-free binary PLY writer and reader, and
merging. Host-side; the file `write_ply` writes is byte-identical to the
JAX package's for the same points and colours."""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from sgam_neurips22_tpu_torch.geometry.camera import pixel2cam

_VERTEX = np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])


def pinhole_inverse(k: np.ndarray) -> torch.Tensor:
    """The f32 inverse of a pinhole intrinsics matrix [[fx, 0, cx], [0, fy,
    cy], [0, 0, 1]], rounded as the JAX package's f32 `jnp.linalg.inv`
    rounds it (its LU solve multiplies by the pivots' reciprocals):
    [[1/fx, 0, -(cx * (1/fx))], [0, 1/fy, -(cy * (1/fy))], [0, 0, 1]]."""
    k32 = np.asarray(k, np.float32)
    if k32[0, 1] != 0 or k32[1, 0] != 0 or not np.array_equal(k32[2], np.float32([0, 0, 1])):
        raise ValueError(f"not a pinhole intrinsics matrix (no skew, last row 0 0 1): {k32.tolist()}")
    inv = np.eye(3, dtype=np.float32)
    for i in (0, 1):
        inv[i, i] = np.float32(1.0) / k32[i, i]
        inv[i, 2] = -(k32[i, 2] * inv[i, i])
    return torch.from_numpy(inv)


def unproject_to_color_point_cloud(rgb: np.ndarray, depth: np.ndarray, intrinsics: np.ndarray, c2w: np.ndarray,
                                   stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """One RGB-D frame -> world points [P, 3] and colours [P, 3] in [0, 1].

    Args:
      rgb: [H, W, 3] in [-1, 1] or [0, 1]; depth: [H, W] z-depth (points
        where it is > 0); intrinsics: [3, 3] pinhole K; c2w: [4, 4]
        camera -> world; stride: every stride-th pixel in each axis.
    """
    pts_cam = pixel2cam(torch.as_tensor(np.asarray(depth, np.float32))[None], pinhole_inverse(intrinsics)[None])
    pts_cam = pts_cam[0].numpy()[::stride, ::stride].reshape(-1, 3)
    cols = rgb[::stride, ::stride].reshape(-1, 3)
    if cols.min() < 0:
        cols = (cols + 1.0) / 2.0
    valid = depth[::stride, ::stride].reshape(-1) > 0
    pts_world = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    return pts_world[valid].astype(np.float32), np.clip(cols[valid], 0, 1).astype(np.float32)


def write_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY of points [P, 3] (f32), with uchar colours
    from colors [P, 3] in [0, 1] when given."""
    n = len(points)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {ax}" for ax in "xyz"]
    if colors is not None:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode())
        if colors is not None:
            rec = np.zeros(n, dtype=_VERTEX)
            rec["xyz"] = points.astype("<f4")
            rec["rgb"] = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
            f.write(rec.tobytes())
        else:
            f.write(points.astype("<f4").tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(points [P, 3], colours [P, 3] in [0, 1] or None) of a file that
    `write_ply` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header") + len(b"end_header") + 1
    header = data[:end].decode()
    n = int(next(line for line in header.splitlines() if line.startswith("element vertex")).split()[-1])
    if "property uchar red" in header:
        rec = np.frombuffer(data[end:], dtype=_VERTEX, count=n)
        return rec["xyz"].copy(), rec["rgb"].astype(np.float32) / 255.0
    return np.frombuffer(data[end:], dtype="<f4", count=n * 3).reshape(n, 3).copy(), None


def merge_point_clouds(clouds: Iterable[Tuple[np.ndarray, np.ndarray]]) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate (points, colours) pairs."""
    pts, cols = zip(*clouds)
    return np.concatenate(pts), np.concatenate(cols)
