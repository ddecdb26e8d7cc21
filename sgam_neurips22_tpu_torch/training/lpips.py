"""LPIPS perceptual distance (VGG16 backbone) — port of
`sgam_neurips22_tpu/training/lpips.py`.

A frozen VGG16 feature extractor sliced at relu1_2 / relu2_2 / relu3_3 /
relu4_3 / relu5_3, channel-unit-normalised feature differences, five
bias-free 1x1 heads, a spatial mean, summed. Parameters are `convs.{i}`
(the 13 VGG16 convs) and `lins.{i}` (the heads), the names of the JAX tree
`{"convs": [...], "lins": [...]}`, so the weight bridge carries it one to
one. The pretrained weights are not in the repository:
`random_lpips(seed)` draws the JAX `init_lpips` distributions, which keeps
every shape and the data flow real.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# VGG16 `features` conv layers: (torchvision index, in_ch, out_ch)
VGG16_CONVS = [
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
    (17, 256, 512), (19, 512, 512), (21, 512, 512),
    (24, 512, 512), (26, 512, 512), (28, 512, 512),
]
CONVS_PER_BLOCK = (2, 2, 3, 3, 3)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
# ScalingLayer constants (reference lpips.py:57-63)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(cin, cout, 3, padding=1) for _, cin, cout in VGG16_CONVS)
        self.lins = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False) for c in LPIPS_CHANNELS)
        self.requires_grad_(False)

    def slices(self, x: torch.Tensor) -> list:
        """x [B, 3, H, W] -> the five relu slice outputs (NCHW)."""
        outs, h, ci = [], x, 0
        for block, n in enumerate(CONVS_PER_BLOCK):
            if block > 0:
                h = F.max_pool2d(h, 2, 2)
            for _ in range(n):
                h = torch.relu(self.convs[ci](h))
                ci += 1
            outs.append(h)
        return outs

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Distance per batch element, [B, 1, 1, 1], between NHWC RGB images
        in [-1, 1] (broadcasts into an NHWC L1 map as the JAX result does)."""
        shift = torch.tensor(SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(SCALE, dtype=x.dtype, device=x.device)
        fx = self.slices(((x - shift) / scale).permute(0, 3, 1, 2))
        fy = self.slices(((y - shift) / scale).permute(0, 3, 1, 2))
        total = 0
        for k in range(len(LPIPS_CHANNELS)):
            d = (_unit_normalize(fx[k]) - _unit_normalize(fy[k])) ** 2
            total = total + self.lins[k](d).mean(dim=(2, 3), keepdim=True)
        return total.permute(0, 2, 3, 1)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x / (||x||_channels + eps): eps outside the sqrt, as the reference."""
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


def random_lpips(seed: int) -> LPIPS:
    """A CPU LPIPS with seeded weights drawn as the JAX `init_lpips`:
    VGG convs uniform(+-1/sqrt(fan_in)) for kernel and bias, heads
    uniform(0, 0.1)."""
    model = LPIPS()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in model.convs:
            bound = 1.0 / math.sqrt(conv.weight[0].numel())
            for p in (conv.weight, conv.bias):
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
        for lin in model.lins:
            lin.weight.copy_(torch.rand(lin.weight.shape, generator=gen) * 0.1)
    return model
