# Frozen copy of sgam_neurips22_tpu_torch/training/discriminator.py at commit e4e59b7, kept as the
# benchmark's plain reference: imports point into portbench.reference, and
# the hand kernels are replaced by the plain PyTorch versions of plain_ops.
"""PatchGAN discriminator (pix2pix NLayerDiscriminator) — port of
`sgam_neurips22_tpu/training/discriminator.py`.

Conv(k4, s2) + LeakyReLU(0.2), then n_layers of Conv + BatchNorm + LeakyReLU
with doubling filters, a stride-1 block, and a 1-channel logit conv. The
layers sit in `main`, an nn.Sequential indexed like the reference's, so the
JAX `{"main": [...]}` parameter and state trees map one to one through the
weight bridge. Input and output are NHWC, as the JAX function's.

BatchNorm uses batch statistics in train mode and running statistics in
eval mode, as the JAX `_batch_norm`; the running statistics are buffers
updated in place by a train-mode call. `apply_keeping_stats` runs a
train-mode call that leaves them as they were, which is what the JAX
generator loss does when it drops the new state. Under a process group
the batch is the global one, as under JAX's mesh: the sums, then the
squared deviations, are summed over the ranks by a differentiable
all-reduce, so the statistics, the running variance's count and the
backward pass are global; every rank must then call the discriminator in
the same order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn



class DiscConfig(NamedTuple):
    input_nc: int = 4
    ndf: int = 64
    n_layers: int = 3
    kernel_width: int = 4


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (momentum 0.1, eps 1e-5, unbiased running variance)
    without `num_batches_tracked`: the JAX state holds only the running mean
    and variance, and a set momentum never reads the count."""

    def __init__(self, c: int):
        super().__init__(c)
        self.num_batches_tracked = None

    def _load_from_state_dict(self, *args, **kwargs):
        # skip BatchNorm's hook, which adds the count to an unversioned state_dict
        nn.Module._load_from_state_dict(self, *args, **kwargs)


class NLayerDiscriminator(nn.Module):
    def __init__(self, cfg: DiscConfig = DiscConfig()):
        super().__init__()
        kw = cfg.kernel_width
        layers = [nn.Conv2d(cfg.input_nc, cfg.ndf, kw, 2, 1), nn.LeakyReLU(0.2)]
        nf_mult = 1
        for n in range(1, cfg.n_layers + 1):
            nf_prev, nf_mult = nf_mult, min(2**n, 8)
            stride = 2 if n < cfg.n_layers else 1
            layers += [
                nn.Conv2d(cfg.ndf * nf_prev, cfg.ndf * nf_mult, kw, stride, 1, bias=False),
                BatchNorm(cfg.ndf * nf_mult),
                nn.LeakyReLU(0.2),
            ]
        layers.append(nn.Conv2d(cfg.ndf * nf_mult, 1, kw, 1, 1))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> patch logits [B, h', w', 1]."""
        return self.main(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def apply_keeping_stats(disc: NLayerDiscriminator, x: torch.Tensor) -> torch.Tensor:
    """disc(x) in train mode (batch statistics) with its parameters detached
    and its running statistics left as they were: the generator side of the
    GAN loss, whose gradients never reach the discriminator."""
    state = {k: p.detach() for k, p in disc.named_parameters()}
    state.update({k: b.clone() for k, b in disc.named_buffers()})
    return torch.func.functional_call(disc, state, (x,))
