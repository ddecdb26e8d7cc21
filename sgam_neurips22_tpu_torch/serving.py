"""The flagship model configurations and inference weights — port of
`flagship_config` and `load_inference_params` (its reference-checkpoint
and run-directory branches) in `sgam_neurips22_tpu/serving.py`."""
from __future__ import annotations

import os
from dataclasses import replace

import torch

from sgam_neurips22_tpu_torch.core.checkpoint import CKPT_FILE, checkpoint_file
from sgam_neurips22_tpu_torch.models.vqgan.autoencoder import DDConfig
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModelConfig


def flagship_config(dataset: str = "clevr-infinite", compute_dtype: str = "float32") -> VQModelConfig:
    """Full-size conditional-generation config for either dataset
    (reference configs/conditional_generation/{clevr-infinite,
    google_earth_vqgan}.yaml): ch 128, ch_mult (1,1,2,2,4), attention at
    tracked resolution 16, embed_dim 256; clevr-infinite's codebook of
    16384 and depth range (7, 16), google_earth's codebook of 4096 and
    depth range (0.099975586, 4.765625); activations in `compute_dtype`."""
    dd = DDConfig(
        ch=128, out_ch=4, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
        attn_resolutions=(16,), resolution=64, z_channels=256, in_channels=4,
        compute_dtype=compute_dtype,
    )
    cfg = VQModelConfig(
        ddconfig=dd, n_embed=16384, embed_dim=256,
        phase="conditional_generation", dataset="clevr-infinite", depth_range=(7.0, 16.0),
    )
    if dataset == "google_earth":
        return replace(cfg, n_embed=4096, dataset="google_earth", depth_range=(0.099975586, 4.765625))
    if dataset != "clevr-infinite":
        raise ValueError(f"unknown dataset {dataset!r}")
    return cfg


def load_inference_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a checkpoint into `model`, as the JAX package merges one: a
    reference torch checkpoint (a Lightning `.ckpt`, or a bare state_dict),
    or the port trainer's own, given as its run directory, the run's
    `checkpoints/` or one step directory (the latest step first). The
    `state_dict` entry is used if there is one, without the loss's `loss.*`
    and `perceptual_loss.*` tensors; every other tensor whose name and
    shape the model has replaces the model's, and the rest of the model
    keeps its weights (a non-strict load). The checkpoint is unpickled
    whole, as the reference's loader does: load only files you trust.

    The JAX package's other forms, a `.pkl` of its parameter tree and an
    orbax checkpoint directory of its trainer, hold JAX pytrees and raise
    here (ROADMAP.md, queue item 1.5)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if os.path.isdir(path):
        ckpt = checkpoint_file(path)
        if ckpt is None:
            raise NotImplementedError(
                f"{path}: no port checkpoint (<step>/{CKPT_FILE}) here; the JAX package's orbax checkpoints hold "
                "JAX parameter trees, which the port does not read (ROADMAP.md, queue item 1.5)")
        path = ckpt
    elif path.endswith(".pkl"):
        raise NotImplementedError(
            f"{path}: the JAX package's .pkl holds a JAX parameter tree, which the port does not read "
            "(ROADMAP.md, queue item 1.5); pass a reference torch .ckpt or a port run directory")
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    own = model.state_dict()
    merged = dict(own)
    for name, tensor in sd.items():
        if name.split(".")[0] in ("loss", "perceptual_loss") or name not in own:
            continue
        tensor = torch.as_tensor(tensor)
        if tuple(tensor.shape) == tuple(own[name].shape):
            merged[name] = tensor.to(own[name].dtype)
    model.load_state_dict(merged)
    return model
