"""Convert Blender EXR renders to training files — the port's counterpart of
`tools/convert_exr.py`, with its CLI and outputs:

    python -m sgam_neurips22_tpu_torch.convert_exr INPUT_DIR [--out DIR]

The sorted `*.exr` files of INPUT_DIR, numbered from 0, each become
im_XXXXX.png (the sRGB tone-mapped colour, `linear_to_srgb`, as
clip(x * 255, 0, 255) in uint8), dm_XXXXX.npy (depth, float32) and, where
the render has an object-index pass, in_XXXXX.npy (float32). Offline host
tooling: files are read by the port's own reader (`pipeline/exr.py`,
numpy, zlib and a C++ Huffman decoder: scanline and tiled files and a
multipart file's first part, with any of OpenEXR's compressions, DWAA and
DWAB included; deep files and subsampled channels raise, naming what they
lack, as OpenEXR's InputFile refuses them) and PNGs written by
`pipeline/png.py`, with neither the OpenEXR package nor OpenCV.

Channels are found by suffix, as the JAX tool's multilayer reader finds
them, so both Blender view-layer namings ("View Layer.Depth.Z" in 2.9x,
"ViewLayer.Depth.Z" in newer builds) and composite-less renders work:
colour `Combined.R/G/B` or `R/G/B` (a file without them raises), depth
`Depth.Z` or `Z`, instances `IndexOB.X`. A single-layer file (no channel
in a layer) without a Z channel keeps the conventions of the JAX tool's
OpenCV branch: in an RGBA file depth is the alpha channel; in an RGB file
it comes from a sibling file whose name swaps Image for Depth (its Z
channel, or its only channel), and the colour file is never read as depth.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from sgam_neurips22_tpu_torch.pipeline.exr import read_exr
from sgam_neurips22_tpu_torch.pipeline.png import write_png


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    """Standard sRGB OETF."""
    a = 0.055
    return np.where(x <= 0.0031308, 12.92 * x, (1 + a) * np.power(np.clip(x, 0, None), 1 / 2.4) - a)


def _find(names, suffixes):
    for suf in suffixes:
        for n in names:
            if n == suf or n.endswith("." + suf):
                return n
    return None


def _sibling_depth(exr_path: str):
    """The depth of an RGB single-layer file's Image -> Depth sibling, or
    None where the name swap changes nothing or no such file exists."""
    depth_path = exr_path.replace("Image", "Depth").replace("image", "depth")
    if depth_path == exr_path or not os.path.exists(depth_path):
        return None
    hdr, planes = read_exr(depth_path)
    names = [ch.name for ch in hdr.channels]
    name = _find(names, ["Depth.Z", "Z"]) or (names[0] if len(names) == 1 else None)
    if name is None:
        raise ValueError(f"{depth_path}: a depth file needs a Z channel or a single channel, not {names}")
    return planes[name].astype(np.float32)


def read_render(exr_path: str):
    """(rgb [H, W, 3] linear, depth [H, W] or None, instance [H, W] or
    None), float32 (HALF and UINT channels widened as OpenEXR's FLOAT read
    widens them)."""
    hdr, planes = read_exr(exr_path)
    names = [ch.name for ch in hdr.channels]

    def read(name):
        return planes[name].astype(np.float32)

    rgb_names = [_find(names, [f"Combined.{c}", c]) for c in ("R", "G", "B")]
    if any(n is None for n in rgb_names):
        raise ValueError(f"{exr_path}: no RGB channels among {names}")
    rgb = np.stack([read(n) for n in rgb_names], axis=2)
    depth_name = _find(names, ["Depth.Z", "Z"])
    if depth_name:
        depth = read(depth_name)
    elif any("." in n for n in names):
        depth = None
    elif "A" in names:  # single-layer RGBA dump: depth in alpha
        depth = read("A")
    else:
        depth = _sibling_depth(exr_path)
    inst_name = _find(names, ["IndexOB.X"])
    instance = read(inst_name) if inst_name else None
    return rgb, depth, instance


def convert_one(exr_path: str, out_dir: str, index: int) -> None:
    rgb, depth, instance = read_render(exr_path)
    srgb = np.clip(linear_to_srgb(rgb) * 255.0, 0, 255).astype(np.uint8)
    write_png(os.path.join(out_dir, f"im_{index:05d}.png"), srgb)
    if depth is not None:
        np.save(os.path.join(out_dir, f"dm_{index:05d}.npy"), depth.astype(np.float32))
    if instance is not None:
        np.save(os.path.join(out_dir, f"in_{index:05d}.npy"), instance.astype(np.float32))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input_dir", help="directory of .exr renders")
    p.add_argument("--out", default=None, help="output dir (default: input_dir)")
    args = p.parse_args(argv)
    out = args.out or args.input_dir
    os.makedirs(out, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.input_dir, "*.exr")))
    if not paths:
        raise FileNotFoundError(f"no .exr under {args.input_dir}")
    for i, path in enumerate(paths):
        convert_one(path, out, i)
        print(f"{path} -> im/dm_{i:05d}")


if __name__ == "__main__":
    main()
