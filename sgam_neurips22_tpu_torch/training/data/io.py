"""Image and depth loading (host-side numpy) — port of the loaders in
`sgam_neurips22_tpu/training/data/io.py` that seed templates and the
training datasets need: RGB PNGs to [-1, 1] (x / 127.5 - 1), depth .npy
files resized by torch's nearest rule, CLEVR's ray depth to z-depth, and
the scaled-inverse-depth channel.

PNGs are decoded without Pillow (`pipeline.png`). Only a PNG whose size
differs from the requested resolution needs Pillow, for the reference's
LANCZOS resize; it is imported in that branch alone.
"""
from __future__ import annotations

import numpy as np

from sgam_neurips22_tpu_torch.pipeline.png import read_png


def load_rgb_u8(path: str, resolution: tuple | None = None) -> np.ndarray:
    """uint8 RGB pixels [H, W, 3] (gray replicated, alpha dropped, as
    Pillow's convert("RGB")), LANCZOS-resized to `resolution` (H, W) when
    the file's size differs."""
    img = read_png(path)
    if resolution is not None and img.shape[:2] != tuple(resolution):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"{path} is {img.shape[1]}x{img.shape[0]}, not {resolution[1]}x{resolution[0]}: resizing it "
                "takes Pillow (the reference's LANCZOS filter), which is not installed; write the template "
                "at the target resolution"
            ) from e
        pil = Image.open(path)
        if pil.mode != "RGB":
            pil = pil.convert("RGB")
        return np.asarray(pil.resize((resolution[1], resolution[0]), resample=Image.LANCZOS), np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3]) if img.shape[2] >= 3 else np.repeat(img[..., :1], 3, axis=-1)


def load_rgb(path: str, resolution: tuple | None = None) -> np.ndarray:
    """[-1, 1] float32 RGB [H, W, 3]."""
    return (load_rgb_u8(path, resolution).astype(np.float32) / 127.5 - 1.0).astype(np.float32)


def resize_nearest(x: np.ndarray, h_out: int, w_out: int) -> np.ndarray:
    """torch F.interpolate(mode="nearest"): out[i] = in[floor(i * in / out)]."""
    h_in, w_in = x.shape[:2]
    if (h_in, w_in) == (h_out, w_out):
        return x
    ys = np.floor(np.arange(h_out) * (h_in / h_out)).astype(np.int64)
    xs = np.floor(np.arange(w_out) * (w_in / w_out)).astype(np.int64)
    return x[ys][:, xs]


def load_depth(path: str, resolution: tuple | None = None) -> np.ndarray:
    """float32 depth [H, W] of a .npy file, nearest-resized to `resolution`."""
    d = np.squeeze(np.load(path).astype(np.float32))
    if resolution is not None:
        d = resize_nearest(d, resolution[0], resolution[1])
    return d


def ray_to_z_np(depth: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Ray depth -> z-depth over the reference's meshgrid convention
    (its data/clevr-infinite.py:99-104)."""
    h, w = depth.shape[:2]
    xs, ys = np.meshgrid(np.linspace(0, w - 1, w), np.linspace(0, h - 1, h))
    return depth * k[0][0] / np.sqrt(k[0][0] ** 2 + (k[0][2] - ys - 0.5) ** 2 + (k[1][2] - xs - 0.5) ** 2)


def encode_disparity_np(depth: np.ndarray, dataset: str) -> np.ndarray:
    """Scaled inverse depth in [-1, 1] (the reference's data/base.py)."""
    if dataset == "google_earth":
        inv = 1.0 / (depth + 10.0)
        unit = (inv - 1 / 14.765625) / (1 / 10.099975586 - 1 / 14.765625)
    elif dataset == "clevr-infinite":
        inv = 1.0 / depth
        unit = (inv - 1 / 16) / (1 / 7 - 1 / 16)
    else:
        raise NotImplementedError(dataset)
    return (2.0 * unit - 1.0).astype(np.float32)
