"""Camera trajectories — numpy copy of
`sgam_neurips22_tpu/pipeline/trajectory.py`: the per-dataset intrinsics,
the pose table `PoseGrid`, and its four builders: the grid, the spiral,
the ring ("cylinder") and a KITTI-360-style pose file. Poses are built as
OpenGL c2w, flipped to OpenCV with diag(1,-1,-1,1), and stored as
world->cam (R, t)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

GL2CV = np.diag([1.0, -1.0, -1.0, 1.0])

# per-dataset start poses and grid steps (reference inference_pipeline.py:160-173)
START_TRANSFORMS = {
    "google_earth": np.array(
        [
            [1.0, 0.0, 0.0, -3.0],
            [0.0, 0.86602527, -0.50000024, -6.0],
            [0.0, 0.50000024, 0.86602527, 2.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    ),
    "clevr-infinite": np.array(
        [
            [1.0, 0.0, 0.0, -20.0],
            [0.0, 0.95533651, -0.29552022, -20.0],
            [0.0, 0.29552022, 0.95533651, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ]
    ),
}
STEP_UNITS = {
    "google_earth": (np.array([0.0, 0.11878788, 0.0]), np.array([0.12, 0.0, 0.0])),
    "clevr-infinite": (np.array([0.0, 0.81632614, 0.0]), np.array([0.81632614, 0.0, 0.0])),
}


def default_intrinsics(dataset: str, image_resolution=(256, 256)) -> np.ndarray:
    """Per-dataset K, scaled from its base resolution (256 for CLEVR, 512
    for GoogleEarth) to `image_resolution`."""
    if dataset == "clevr-infinite":
        k, base = np.array([[355.5555, 0, 128.0], [0, 355.5555, 128.0], [0, 0, 1.0]]), 256
    elif dataset == "google_earth":
        k, base = np.array([[497.77774, 0, 256.0], [0, 497.77774, 256.0], [0, 0, 1.0]]), 512
    else:
        raise NotImplementedError(dataset)
    k[0] *= image_resolution[1] / base
    k[1] *= image_resolution[0] / base
    return k


@dataclass
class PoseGrid:
    """Flat pose table over an (rows, cols) visit grid."""

    rows: int
    cols: int
    R: np.ndarray  # [G, 3, 3] world->cam
    t: np.ndarray  # [G, 3]
    K: np.ndarray  # [3, 3]
    position: np.ndarray  # [G, 3] camera centres
    visited: np.ndarray  # [G] bool
    trajectory_shape: str = "grid"

    def index(self, i: int, j: int) -> int:
        return i * self.cols + j

    def coord(self, idx: int) -> Tuple[int, int]:
        return idx // self.cols, idx % self.cols

    @property
    def size(self) -> int:
        return self.rows * self.cols

    def w2c(self, idx: int) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.R[idx]
        m[:3, 3] = self.t[idx]
        return m

    def c2w(self, idx: int) -> np.ndarray:
        return np.linalg.inv(self.w2c(idx))


def _finalize(rows: int, cols: int, w2cs: List[np.ndarray], k: np.ndarray, shape: str) -> PoseGrid:
    r = np.stack([m[:3, :3] for m in w2cs])
    t = np.stack([m[:3, 3] for m in w2cs])
    return PoseGrid(
        rows=rows, cols=cols, R=r, t=t, K=k,
        position=np.einsum("gji,gj->gi", r, -t),  # -R^T t
        visited=np.zeros(rows * cols, bool), trajectory_shape=shape,
    )


def prepare_grid(
    dataset: str,
    output_dim: Tuple[int, int],
    step_size_denom: float = 2.0,
    intrinsics: Optional[np.ndarray] = None,
) -> PoseGrid:
    """Regular camera grid (reference inference_pipeline.py:157-204)."""
    rows, cols = output_dim
    start = START_TRANSFORMS[dataset]
    step_i, step_j = (s / step_size_denom for s in STEP_UNITS[dataset])
    k = default_intrinsics(dataset) if intrinsics is None else intrinsics
    w2cs = []
    for i in range(rows):
        for j in range(cols):
            c2w = np.eye(4)
            c2w[:3, :3] = start[:3, :3]
            c2w[:3, 3] = start[:3, 3] + step_j * j + step_i * i
            w2cs.append(np.linalg.inv(c2w @ GL2CV))
    return _finalize(rows, cols, w2cs, k, "grid")


def prepare_spiral(
    dataset: str,
    n_frames: int,
    step_size_denom: float = 2.0,
    intrinsics: Optional[np.ndarray] = None,
) -> PoseGrid:
    """Archimedean spiral about the start pose, n_frames x 1 (reference
    inference_pipeline.py:206-287, without its viewer call)."""
    start = START_TRANSFORMS[dataset]
    k = default_intrinsics(dataset) if intrinsics is None else intrinsics
    w2c0 = np.linalg.inv(start @ GL2CV)
    origin = -w2c0[:3, :3].T @ w2c0[:3, 3]
    arc, separation = 1.0, 1.0
    r = arc
    b = separation / (2 * np.pi)
    theta = float(r) / b
    w2cs = []
    for _ in range(n_frames):
        rot = np.array(
            [
                [np.cos(90 - theta), np.sin(90 - theta), 0],
                [-np.sin(90 - theta), np.cos(90 - theta), 0],
                [0, 0, 1],
            ]
        )
        c2w = np.eye(4)
        c2w[:3, 3] = origin
        c2w[0, 3] += theta * np.cos(theta) / 10
        c2w[1, 3] += theta * np.sin(theta) / 10
        c2w[:3, :3] = rot
        w2cs.append(np.linalg.inv(c2w))
        theta += float(arc) / r
        r = b * theta
    return _finalize(n_frames, 1, w2cs, k, "spiral")


def prepare_ring(
    dataset: str,
    n_frames: int,
    step_size_denom: float = 2.0,
    horizontal_offset: float = 0.002,
    intrinsics: Optional[np.ndarray] = None,
) -> PoseGrid:
    """Orbit on a cylinder ("cylinder"), n_frames x 1 (reference
    inference_pipeline.py:289-359)."""
    start = START_TRANSFORMS[dataset]
    step_i, _ = STEP_UNITS[dataset]
    if dataset != "google_earth":
        step_i = -step_i
    step_i = step_i / step_size_denom
    k = default_intrinsics(dataset) if intrinsics is None else intrinsics
    curr = start @ GL2CV
    theta = np.pi / 80
    rot = np.eye(4)
    rot[:3, :3] = np.array([[1, 0, 0], [0, np.cos(theta), np.sin(theta)], [0, -np.sin(theta), np.cos(theta)]])
    w2cs = []
    for _ in range(n_frames):
        trans = np.eye(4)
        trans[:3, 3] = -step_i
        trans[0, 3] = horizontal_offset
        w2c = trans @ rot @ np.linalg.inv(curr)
        w2cs.append(w2c)
        curr = np.linalg.inv(w2c)
    return _finalize(n_frames, 1, w2cs, k, "cylinder")


def load_poses(pose_file: str) -> Dict[int, np.ndarray]:
    """frame index -> 4x4 c2w from a KITTI-360-style cam0_to_world.txt
    (each line: the index, then the 16 entries of the matrix)."""
    poses = np.loadtxt(pose_file)
    return dict(zip(poses[:, 0].astype(int), poses[:, 1:].reshape(-1, 4, 4)))


def prepare_trajectory(
    dataset: str,
    pose_file: str,
    n_frames: int,
    start_frame: Optional[int] = None,
    intrinsics: Optional[np.ndarray] = None,
) -> PoseGrid:
    """n_frames x 1 poses of a pose file, from `start_frame` (the first
    index by default) in index order (reference inference_pipeline.py:369-421)."""
    poses = load_poses(pose_file)
    keys = sorted(poses)
    start = keys.index(start_frame) if start_frame is not None else 0
    if start + n_frames > len(keys):
        raise ValueError("trajectory shorter than requested length")
    k = default_intrinsics(dataset) if intrinsics is None else intrinsics
    w2cs = [np.linalg.inv(poses[keys[start + i]]) for i in range(n_frames)]
    return _finalize(n_frames, 1, w2cs, k, "trajectory")
