"""The weight bridge: reference-layout state_dicts in and out of the port.

Weights use the reference torch state_dict names
(`encoder.down.0.block.0.norm1.weight`, ..., `quantize.embedding.weight`)
and OIHW conv kernels, so `load_state_dict` maps one to one.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


def from_jax_params(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """JAX parameter tree (numpy leaves) -> flat reference state_dict.

    The port's own copy of the walk in the JAX package's
    `core/torch_convert.params_to_state_dict`: dicts and lists become dotted
    names, 4-D HWIO conv kernels become OIHW, and `quantize.embedding`
    gains its `.weight` suffix."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        elif node is not None:
            arr = np.asarray(node)
            if path.endswith("quantize.embedding"):
                path = path + ".weight"
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            out[path] = arr

    walk(tree, prefix)
    return out


def load_into(model: nn.Module, state_dict: Dict[str, Any]) -> nn.Module:
    """Strict load: raises on a missing or unexpected key or a shape that
    differs, then copies every tensor into `model` (on its device)."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(own))
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing={missing} unexpected={unexpected}")
    tensors = {}
    for k, v in state_dict.items():
        t = v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(t.shape)} != model {tuple(own[k].shape)}")
        tensors[k] = t.to(own[k].dtype)
    model.load_state_dict(tensors, strict=True)
    return model


def load_jax_training(
    model: nn.Module,
    disc: nn.Module,
    params: Dict[str, Any],
    disc_params: Dict[str, Any],
    disc_state: Dict[str, Any],
    lpips: Optional[nn.Module] = None,
    lpips_params: Optional[Dict[str, Any]] = None,
) -> None:
    """Carry the JAX training state (numpy leaves) into the port's modules,
    strictly: `params` (the JAX `create_train_state(...)["params"]`) into
    the VQModel, `disc_params` and `disc_state` (the discriminator's
    `{"main": [...]}` trees, BatchNorm running statistics in the latter)
    into the discriminator, and an `init_lpips`-layout
    `{"convs", "lins"}` tree into the LPIPS module. Tensors are copied into
    the existing parameters, so optimizers built on them stay valid; their
    moments are whatever they were (zero before the first step)."""
    load_into(model, from_jax_params(params))
    load_into(disc, {**from_jax_params(disc_params), **from_jax_params(disc_state)})
    if lpips is not None:
        load_into(lpips, from_jax_params(lpips_params))


def random_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights (CPU `torch.Generator`) with the reference
    init's distributions, as the JAX package's initialisers draw them:
    torch's Conv2d default (uniform +-1/sqrt(fan_in) for kernel and bias),
    GroupNorm weight 1 / bias 0, codebook uniform(-1/n, 1/n)."""
    gen = torch.Generator().manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, nn.Conv2d):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            for p in ("weight", "bias"):
                shape = getattr(mod, p).shape
                out[pre + p] = (torch.rand(shape, generator=gen) * 2 - 1) * bound
        elif isinstance(mod, nn.GroupNorm):
            out[pre + "weight"] = torch.ones(mod.num_channels)
            out[pre + "bias"] = torch.zeros(mod.num_channels)
        elif isinstance(mod, nn.Embedding):
            n = mod.num_embeddings
            out[pre + "weight"] = (torch.rand(mod.weight.shape, generator=gen) * 2 - 1) / n
    return out
