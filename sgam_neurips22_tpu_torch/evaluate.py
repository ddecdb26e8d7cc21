"""Offline evaluation: PSNR / SSIM / FID between two image directories (the
port of the repository's `evaluate.py`, with the same flags and JSON keys).

  python -m sgam_neurips22_tpu_torch.evaluate generated_dir gt_dir \
      [--masks mask_dir] [--fid] [--lpips_weights weights/lpips.pkl] [--device cpu]

Images pair by sorted file name (`im_*.png`, else `*.png`). Masks
(optional: a `<name>.npy` visibility mask a frame, [H, W] or [H, W, 3])
add the visible-only PSNR and SSIM, averaged with nanmean (a frame whose
mask is empty scores NaN and is left out). `--fid` adds `fid_vgg`, the
Frechet distance between the directories' VGG16 relu5_3 features; its
weights come from `--lpips_weights` (a pickle of the JAX `init_lpips`
tree, numpy or jax.Array leaves, as the trainer reads it: the port's
`convert_lpips` writes one), else seeded random ones
with a warning. The metrics run in float64 on `--device` (`cuda` by
default; without a GPU it raises unless `--device cpu` is given).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from sgam_neurips22_tpu_torch.core.device import resolve_device
from sgam_neurips22_tpu_torch.training.data.io import load_rgb_u8
from sgam_neurips22_tpu_torch.utils.metrics import psnr, ssim


def _pngs(path: str) -> list:
    return sorted(glob.glob(os.path.join(path, "im_*.png"))) or sorted(glob.glob(os.path.join(path, "*.png")))


def load_pairs(gen_dir: str, gt_dir: str, device: torch.device):
    """(file name, generated [H, W, 3], ground truth [H, W, 3]) float64
    tensors on `device` in [0, 255], paired by sorted name."""
    gen, gt = _pngs(gen_dir), _pngs(gt_dir)
    n = min(len(gen), len(gt))
    if n == 0:
        raise FileNotFoundError("no paired images found")
    for g, t in zip(gen[:n], gt[:n]):
        a = torch.as_tensor(load_rgb_u8(g), device=device).double()
        b = torch.as_tensor(load_rgb_u8(t), device=device).double()
        yield os.path.basename(g), a, b


def load_lpips(path: str, device: torch.device):
    """The LPIPS module whose VGG16 gives the FID features: the pickled
    `init_lpips` tree at `path` (numpy or jax.Array leaves, read without
    JAX), else seeded random weights (seed 0)."""
    from sgam_neurips22_tpu_torch.core.state_dict import from_jax_params, load_into, load_tree_pickle
    from sgam_neurips22_tpu_torch.training.lpips import LPIPS, random_lpips

    if path and os.path.exists(path):
        lp = load_into(LPIPS(), from_jax_params(load_tree_pickle(path)))
    else:
        print("WARNING: FID with randomly initialized VGG features (numbers not comparable across machines)")
        lp = random_lpips(0)
    return lp.to(device).eval()


def main(argv=None) -> dict:
    """Print (and return) evaluate.py's JSON: psnr, ssim, n_frames; with
    masks psnr_visible, ssim_visible, n_frames_visible; with --fid, fid_vgg."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("generated")
    p.add_argument("gt")
    p.add_argument("--masks", default=None, help="dir of per-frame .npy visibility masks")
    p.add_argument("--fid", action="store_true")
    p.add_argument("--lpips_weights", default="weights/lpips.pkl")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    psnrs, ssims, vis_psnrs, vis_ssims = [], [], [], []
    for name, a, b in load_pairs(args.generated, args.gt, dev):
        mask = None
        if args.masks:
            mpath = os.path.join(args.masks, os.path.splitext(name)[0] + ".npy")
            if os.path.exists(mpath):
                m = torch.as_tensor(np.load(mpath).astype(np.float64), device=dev)
                mask = m[..., None].expand(*m.shape, 3) if m.dim() == 2 else m
        if mask is not None:
            f, v = psnr(a, b, mask)
            psnrs.append(f)
            vis_psnrs.append(v)
            f, v = ssim(a, b, mask)
            ssims.append(f)
            vis_ssims.append(v)
        else:
            psnrs.append(psnr(a, b))
            ssims.append(ssim(a, b))
    out = {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)), "n_frames": len(psnrs)}
    if vis_psnrs:
        # nanmean: a frame with an empty mask scores NaN and is left out
        out["psnr_visible"] = float(np.nanmean(vis_psnrs))
        out["ssim_visible"] = float(np.nanmean(vis_ssims))
        out["n_frames_visible"] = int(np.sum(~np.isnan(vis_psnrs)))
    if args.fid:
        from sgam_neurips22_tpu_torch.utils.fid import get_fid_score

        out["fid_vgg"] = get_fid_score(args.generated, args.gt, lpips=load_lpips(args.lpips_weights, dev))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
