"""Build LPIPS weights from torch files, without JAX — the port's
counterpart of `tools/convert_lpips.py`, with its flags:

    python -m sgam_neurips22_tpu_torch.convert_lpips --vgg vgg16-397923af.pth \\
        --lin vgg.pth [--out weights/lpips.pkl]

Inputs:
  --vgg: a torchvision VGG16 state_dict file (e.g. vgg16-397923af.pth, keys
         `features.N.weight`) or a state_dict of its `features` alone (keys
         `N.weight`), or a full-model checkpoint holding either.
  --lin: the LPIPS linear heads (the reference's
         sgam/generative_sensing_module/modules/autoencoder/lpips/vgg.pth,
         keys `lin{0..4}.model.1.weight`).
Output: a pickle of the JAX `init_lpips` tree, `{"convs": [{"weight",
  "bias"}, ...], "lins": [{"weight"}, ...]}`, HWIO kernels, numpy float32
  leaves, the same values as the JAX tool writes: the port's trainer
  (`--lpips_weights`) and evaluate CLI read it, and so does the JAX package.
"""
from __future__ import annotations

import argparse
import os
import pickle
import warnings
from typing import Any, Dict

import numpy as np
import torch

from sgam_neurips22_tpu_torch.training.lpips import LPIPS, VGG16_CONVS


def _feature(vgg_sd: Dict[str, Any], key: str):
    """A torchvision `features` tensor, its key with or without the
    `features.` prefix."""
    return vgg_sd[key] if key in vgg_sd else vgg_sd[f"features.{key}"]


def lpips_from_torch(vgg_sd: Dict[str, Any], lin_sd: Dict[str, Any]) -> LPIPS:
    """The port's LPIPS module from a torchvision VGG16 state_dict
    (`features.N.*` or `N.*` keys, OIHW) and the LPIPS heads' state_dict
    (`lin{i}.model.1.weight`), as the JAX `convert_torch_lpips` maps them."""
    sd = {}
    for i, (idx, _, _) in enumerate(VGG16_CONVS):
        sd[f"convs.{i}.weight"] = torch.as_tensor(_feature(vgg_sd, f"{idx}.weight"))
        sd[f"convs.{i}.bias"] = torch.as_tensor(_feature(vgg_sd, f"{idx}.bias"))
    for i in range(5):
        sd[f"lins.{i}.weight"] = torch.as_tensor(lin_sd[f"lin{i}.model.1.weight"])
    lp = LPIPS()
    lp.load_state_dict({k: v.to(torch.float32) for k, v in sd.items()})
    return lp.eval()


def lpips_tree(lp: LPIPS) -> dict:
    """The JAX `init_lpips` tree of an LPIPS module: HWIO kernels, numpy
    float32 leaves."""
    def hwio(w):
        return np.ascontiguousarray(w.detach().cpu().numpy().transpose(2, 3, 1, 0))

    return {"convs": [{"weight": hwio(c.weight), "bias": c.bias.detach().cpu().numpy().copy()} for c in lp.convs],
            "lins": [{"weight": hwio(c.weight)} for c in lp.lins]}


def load_torch_file(path: str) -> Dict[str, Any]:
    """A state_dict from a torch file: read with weights_only=True where the
    file allows it; a full-model pickle is unpickled whole (trusted files
    only) and its `state_dict()` taken, as the JAX tool does."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        warnings.warn(f"{path} is not a plain state_dict; unpickling it whole (load only files you trust)")
        obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vgg", required=True)
    p.add_argument("--lin", required=True)
    p.add_argument("--out", default="weights/lpips.pkl")
    args = p.parse_args(argv)
    tree = lpips_tree(lpips_from_torch(load_torch_file(args.vgg), load_torch_file(args.lin)))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(tree, f)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
