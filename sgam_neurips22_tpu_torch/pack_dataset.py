"""Pack an RGB-D dataset into mmap-able SGPK shards, without JAX — the
port's counterpart of `tools/pack_dataset.py`, with its flags and its
files:

    python -m sgam_neurips22_tpu_torch.pack_dataset --dataset_dir /data/clevr \\
        --dataset clevr-infinite [--phase codebook|pair] [--resolution 256 256] \\
        [--splits train val] [--no_depth] [--no_convert_depth]

Decode, LANCZOS resize (where a PNG's size differs from --resolution), ray
to z and disparity encoding happen once here (`training.data.packed.
pack_split`); the trainer's loader then assembles batches straight from the
shard in C++ threads, bit-identical to the PNG path. --phase pair packs
every pose-graph frame of a conditional-generation dataset into a
raw-depth frame store and its JSON index (`pack_pair_frames`).

Writes {dataset_dir}/{split}_{H}x{W}.sgpk (codebook) or the frame store at
`frame_store_path` (pair), the names `DataModule(packed="auto")` looks for.
"""
from __future__ import annotations

import argparse

from sgam_neurips22_tpu_torch.training.data.codebook_dataset import CodebookDataset
from sgam_neurips22_tpu_torch.training.data.datamodule import PAIR_DATASETS
from sgam_neurips22_tpu_torch.training.data.packed import frame_store_path, pack_pair_frames, pack_split, shard_path


def main(argv=None) -> list:
    """Pack each split; returns the files written."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--dataset", required=True, choices=["clevr-infinite", "google_earth"])
    p.add_argument("--phase", default="codebook", choices=["codebook", "pair"],
                   help="codebook: final [-1,1]+disparity examples; pair: per-frame RGB + metric-depth store for "
                        "the conditional-generation datasets")
    p.add_argument("--resolution", type=int, nargs=2, default=[256, 256])
    p.add_argument("--splits", nargs="*", default=["train", "val"])
    p.add_argument("--no_depth", action="store_true")
    p.add_argument("--no_convert_depth", action="store_true", help="codebook: skip the CLEVR ray->z conversion")
    args = p.parse_args(argv)

    written = []
    for split in args.splits:
        if args.phase == "pair":
            ds = PAIR_DATASETS[args.dataset](split, args.dataset_dir, image_resolution=tuple(args.resolution))
            out = frame_store_path(args.dataset_dir, split, args.resolution)
            print(f"packing {split} frames: {len(ds)} -> {out}")
            pack_pair_frames(ds, out)
        else:
            ds = CodebookDataset(split, args.dataset_dir, args.dataset, image_resolution=tuple(args.resolution),
                                 convert_depth=not args.no_convert_depth, use_depth=not args.no_depth)
            out = shard_path(args.dataset_dir, split, args.resolution)
            print(f"packing {split}: {len(ds)} examples -> {out}")
            pack_split(ds, out, use_depth=not args.no_depth)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
