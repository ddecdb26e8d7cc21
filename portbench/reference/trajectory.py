# Frozen copy of sgam_neurips22_tpu_torch/pipeline/trajectory.py at commit e4e59b7, kept as the
# benchmark's plain reference: imports point into portbench.reference, and
# the hand kernels are replaced by the plain PyTorch versions of plain_ops.
"""Camera trajectories — numpy copy of
`sgam_neurips22_tpu/pipeline/trajectory.py`: the per-dataset intrinsics,
the pose table `PoseGrid` and its grid builder (the copy keeps only what
the benchmark runs). Poses are built as OpenGL c2w, flipped to OpenCV with
diag(1,-1,-1,1), and stored as world->cam (R, t)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

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

