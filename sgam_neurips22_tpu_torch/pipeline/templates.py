"""Seed frames from the reference's template layout — port of
`sgam_neurips22_tpu/pipeline/templates.py`:
- clevr-infinite: `dm_<n>_<i>_<j>.npy` ray depth (converted to z-depth)
  beside `im_<n>_<i>_<j>.png`, each pair seeding grid coord (i, j);
- google_earth: `seed<k>/im_*.png` and its `dm_*.npy`, at (0, 0).
"""
from __future__ import annotations

import glob
import os

import numpy as np

from sgam_neurips22_tpu_torch.pipeline.trajectory import default_intrinsics
from sgam_neurips22_tpu_torch.training.data.io import load_depth, load_rgb, ray_to_z_np


def _sibling(path: str, old: str, new: str, old_ext: str, new_ext: str) -> str:
    """`path` with the first `old` of its basename replaced by `new` and its
    extension by `new_ext` (the directories are left alone)."""
    d, base = os.path.split(path)
    return os.path.join(d, base.replace(old, new, 1)[: -len(old_ext)] + new_ext)


def load_seed_frames(template_dir: str, dataset: str, seed_index: int, resolution) -> list:
    """[(grid coord (i, j), rgb [H, W, 3] in [-1, 1], z-depth [H, W])]."""
    seeds = []
    k = default_intrinsics(dataset, resolution)
    if dataset == "clevr-infinite":
        for dm_path in sorted(glob.glob(os.path.join(template_dir, "dm_*.npy"))):
            parts = os.path.basename(dm_path)[3:-4].split("_")
            coord = (int(parts[1]), int(parts[2])) if len(parts) >= 3 else (0, 0)
            depth = ray_to_z_np(load_depth(dm_path, resolution), k)
            rgb = load_rgb(_sibling(dm_path, "dm", "im", ".npy", ".png"), resolution)
            seeds.append((coord, rgb, depth.astype(np.float32)))
    elif dataset == "google_earth":
        seed_dir = os.path.join(template_dir, f"seed{seed_index}")
        images = sorted(glob.glob(os.path.join(seed_dir, "im*")))
        if images:
            rgb = load_rgb(images[0], resolution)
            depth = load_depth(_sibling(images[0], "im", "dm", ".png", ".npy"), resolution)
            seeds.append(((0, 0), rgb, depth.astype(np.float32)))
    else:
        raise NotImplementedError(dataset)
    if not seeds:
        raise FileNotFoundError(f"no seed frames under {template_dir}")
    return seeds
