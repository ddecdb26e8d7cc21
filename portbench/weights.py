"""Weights made from the run's seed on the device, in a few large draws,
laid out as the frozen reference's modules name them (the reference
torch state_dict layout, which the port loads one to one).

The distributions are the reference init's (the port's `random_state_dict`,
`init_discriminator` and `random_lpips` at commit e4e59b7), but for the
codebook, whose rows are drawn N(0, codebook_std^2) (the configuration's
`assumed`): a trained codebook lies among the encoder's latents, while the
init's uniform(-1/n, 1/n) rows lie within f32 rounding of one another
against a latent's length, so that the nearest codeword is a tie.
- VQGAN and LPIPS convolutions: weight and bias uniform(+-1/sqrt(fan_in));
  GroupNorm weight 1, bias 0; LPIPS heads uniform(0, 0.1);
- discriminator: convolutions normal(0, 0.02), bias 0; BatchNorm weight
  normal(1, 0.02), bias 0, running mean 0, variance 1.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def _draw(specs, gen, device, sampler) -> list:
    """One draw for all `specs` [(shape, scale, shift)]: views of one flat
    tensor, each scaled and shifted."""
    sizes = [math.prod(shape) for shape, _, _ in specs]
    flat = torch.empty(sum(sizes), device=device)
    sampler(flat, gen)
    out, at = [], 0
    for (shape, scale, shift), n in zip(specs, sizes):
        out.append(flat[at:at + n].view(shape).mul_(scale).add_(shift))
        at += n
    return out


def _uniform(flat, gen):
    flat.uniform_(-1.0, 1.0, generator=gen)


def _normal(flat, gen):
    flat.normal_(0.0, 1.0, generator=gen)


def _fill(module: nn.Module, rules, gen, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} of `module`'s state: `rules(mod)` gives each
    submodule's [(param name, "uniform" | "normal" | "const", scale, shift,
    shape)]."""
    plan = {"uniform": [], "normal": []}
    out: Dict[str, torch.Tensor] = {}
    for name, mod in module.named_modules():
        pre = f"{name}." if name else ""
        for pname, kind, scale, shift, shape in rules(mod):
            if kind == "const":
                out[pre + pname] = torch.full(shape, shift, device=device)
            else:
                plan[kind].append((pre + pname, (shape, scale, shift)))
    for kind, sampler in (("uniform", _uniform), ("normal", _normal)):
        if plan[kind]:
            for (name, _), t in zip(plan[kind], _draw([s for _, s in plan[kind]], gen, device, sampler)):
                out[name] = t
    return out


def vq_weights(model: nn.Module, seed: int, device, codebook_std: float) -> Dict[str, torch.Tensor]:
    """The VQModel's weights (`model` may live on the meta device)."""
    def rules(mod):
        if isinstance(mod, nn.Conv2d):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            return [("weight", "uniform", bound, 0.0, mod.weight.shape), ("bias", "uniform", bound, 0.0, mod.bias.shape)]
        if isinstance(mod, nn.GroupNorm):
            return [("weight", "const", 0.0, 1.0, mod.weight.shape), ("bias", "const", 0.0, 0.0, mod.bias.shape)]
        if isinstance(mod, nn.Embedding):
            return [("weight", "normal", codebook_std, 0.0, mod.weight.shape)]
        return []

    return _fill(model, rules, torch.Generator(device=device).manual_seed(seed), device)


def disc_weights(disc: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    def rules(mod):
        if isinstance(mod, nn.Conv2d):
            out = [("weight", "normal", 0.02, 0.0, mod.weight.shape)]
            return out + ([("bias", "const", 0.0, 0.0, mod.bias.shape)] if mod.bias is not None else [])
        if isinstance(mod, nn.BatchNorm2d):
            c = mod.weight.shape
            return [("weight", "normal", 0.02, 1.0, c), ("bias", "const", 0.0, 0.0, c),
                    ("running_mean", "const", 0.0, 0.0, c), ("running_var", "const", 0.0, 1.0, c)]
        return []

    return _fill(disc, rules, torch.Generator(device=device).manual_seed(seed + 1), device)


def lpips_weights(lpips: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    def rules(mod):
        if not isinstance(mod, nn.Conv2d):
            return []
        if mod.bias is None:  # a head
            return [("weight", "uniform", 0.05, 0.05, mod.weight.shape)]
        bound = 1.0 / math.sqrt(mod.weight[0].numel())
        return [("weight", "uniform", bound, 0.0, mod.weight.shape), ("bias", "uniform", bound, 0.0, mod.bias.shape)]

    return _fill(lpips, rules, torch.Generator(device=device).manual_seed(seed + 2), device)
