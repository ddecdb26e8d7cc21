"""Codebook-phase datasets: RGB-D images from train.txt / val.txt file
lists — port of `sgam_neurips22_tpu/training/data/codebook_dataset.py`
(the reference's data/custom_codebook.py and data/base.py): RGB PNG in
[-1, 1], the paired depth .npy found by the im -> dm file-name rewrite,
optional ray -> z conversion, and the scaled-inverse-depth 4th channel.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from sgam_neurips22_tpu_torch.training.data.io import encode_disparity_np, load_depth, load_rgb, ray_to_z_np


class CodebookDataset:
    def __init__(
        self,
        split: str,
        dataset_dir: str,
        dataset: str,
        image_resolution=(256, 256),
        training_images_list_file: Optional[str] = None,
        convert_depth: bool = True,
        use_depth: bool = True,
        val_cap: int = 2500,
        val_seed: int = 3,
    ):
        self.dataset = dataset
        self.dataset_dir = dataset_dir
        self.use_depth = use_depth
        self.convert_depth = convert_depth
        self.image_resolution = tuple(image_resolution)
        list_file = training_images_list_file or os.path.join(
            dataset_dir, f"{'train' if split == 'train' else 'val'}.txt")
        with open(list_file) as f:
            paths = [line.strip() for line in f if line.strip()]
        if split != "train":
            # the reference's seeded shuffle and cap of the validation list
            np.random.RandomState(seed=val_seed).shuffle(paths)
            paths = paths[:val_cap]
        self.paths: List[str] = paths
        if convert_depth:
            k = np.load(os.path.join(dataset_dir, "K.npy")).astype(np.float64)
            # K is stored at 256
            k[0] *= self.image_resolution[1] / 256
            k[1] *= self.image_resolution[0] / 256
            k[2, 2] = 1.0
            self.K = k
        else:
            self.K = None

    def __len__(self) -> int:
        return len(self.paths)

    def _depth_path(self, rgb_path: str) -> str:
        base = os.path.basename(rgb_path).replace("im", "dm").replace(".png", ".npy")
        return os.path.join(os.path.dirname(rgb_path), base)

    def __getitem__(self, i: int) -> dict:
        rgb_path = self.paths[i]
        img = load_rgb(rgb_path, self.image_resolution)
        if not self.use_depth:
            return {"image": img}
        depth = load_depth(self._depth_path(rgb_path), self.image_resolution)
        if self.convert_depth and self.K is not None:
            depth = ray_to_z_np(depth, self.K)
        disparity = encode_disparity_np(depth, self.dataset)
        return {"image": np.concatenate([img, disparity[..., None]], axis=-1)}


class NumpyImageDataset:
    """RGB images stored as .npy arrays [1, 3, H, W] uint8 (the reference's
    `NumpyPaths`) -> [-1, 1] float NHWC. An array of another size than
    `image_resolution` is resized with Pillow's LANCZOS, imported in that
    branch alone."""

    def __init__(self, paths, image_resolution=(256, 256)):
        self.paths = list(paths)
        self.image_resolution = tuple(image_resolution)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> dict:
        arr = np.load(self.paths[i]).squeeze(0).transpose(1, 2, 0).astype(np.uint8)
        if arr.shape[:2] != self.image_resolution:
            from PIL import Image

            arr = np.asarray(Image.fromarray(arr, mode="RGB").resize(
                (self.image_resolution[1], self.image_resolution[0]), Image.LANCZOS))
        return {"image": np.asarray(arr, np.float32) / 127.5 - 1.0}


class ConcatDatasetWithIndex:
    """Concatenated datasets whose items carry their sub-dataset's index
    (the reference's `ConcatDatasetWithIndex`)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumsum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.cumsum[-1]) if len(self.datasets) else 0

    def __getitem__(self, i: int):
        ds_idx = int(np.searchsorted(self.cumsum, i, side="right"))
        base = 0 if ds_idx == 0 else int(self.cumsum[ds_idx - 1])
        item = self.datasets[ds_idx][i - base]
        if isinstance(item, dict):
            item = dict(item)
            item["dataset_index"] = ds_idx
            return item
        return item, ds_idx
