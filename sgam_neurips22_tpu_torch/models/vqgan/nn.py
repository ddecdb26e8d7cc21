"""Building blocks of the taming VQGAN backbone — port of
`sgam_neurips22_tpu/models/vqgan/nn.py`.

Modules run NCHW inside the conv stack; their parameter names are the
reference state_dict's (`norm1`, `conv1`, `nin_shortcut`, `q`, `k`, `v`,
`proj_out`, ...), so checkpoints load one to one. Parameters stay f32;
each conv casts its weight and bias to its input's dtype at every call,
as the JAX `conv2d` does, so a bf16 activation runs a bf16 conv.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sgam_neurips22_tpu_torch.core.dtypes import at_least_f32
from sgam_neurips22_tpu_torch.ops import attention


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Conv2d(nn.Conv2d):
    """nn.Conv2d in its input's dtype: the f32 weight and bias are cast to
    x.dtype at each call (a no-op for f32 input)."""

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride, self.padding)


def conv2d(cin: int, cout: int, k: int = 3, stride: int = 1) -> Conv2d:
    """Conv with SAME padding for stride 1 (k // 2 each side for odd k);
    stride-2 convs are padded by their caller (see Downsample)."""
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2 if stride == 1 else 0)


def group_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
    num_groups: int = 32, eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm over NCHW with f32 statistics composed from per-channel
    moments (a group's mean is the mean of its channels' means), in the
    two-pass form E[(x - mean_g)^2] of the JAX package (float64 input keeps
    float64 statistics)."""
    b, c, _, _ = x.shape
    if c % num_groups != 0:
        raise ValueError(f"GroupNorm: channels ({c}) must be divisible by {num_groups}")
    cg = c // num_groups
    xf = at_least_f32(x)
    gm = xf.mean(dim=(2, 3)).reshape(b, num_groups, cg).mean(dim=2)  # [B, G]
    d = xf - gm.repeat_interleave(cg, dim=1)[:, :, None, None]
    gv = (d * d).mean(dim=(2, 3)).reshape(b, num_groups, cg).mean(dim=2)
    inv = torch.rsqrt(gv + eps).repeat_interleave(cg, dim=1)[:, :, None, None]
    return (d * inv * weight[None, :, None, None] + bias[None, :, None, None]).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6) with the parameters of nn.GroupNorm and the
    statistics of `group_norm`."""

    def __init__(self, c: int):
        super().__init__(32, c, eps=1e-6)

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class Downsample(nn.Module):
    """Asymmetric (0,1)x(0,1) zero pad + 3x3 stride-2 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = conv2d(c, c, 3)

    def forward(self, x):
        return self.conv(upsample_nearest2x(x))


class ResnetBlock(nn.Module):
    """GroupNorm -> swish -> 3x3 conv, twice, + (1x1-projected) skip."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = conv2d(cin, cout)
        self.norm2 = GroupNorm(cout)
        self.conv2 = conv2d(cout, cout)
        if cin != cout:
            self.nin_shortcut = conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(swish(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W tokens.

    The attention path is chosen by the caller, as the JAX `attn_block(...,
    flash=cfg.flash_attention)` takes it from its config: `flash` (from
    `DDConfig.flash_attention`) is the block's default, and a `forward(x,
    flash=...)` that is not None overrides it for that call. Flash goes
    through `ops.attention.flash_attention`: the flash-attention kernel on
    the card, its plain version on the CPU (which rounds as the kernel
    does: scale on q before the dot); it computes in f32 and returns the
    input's dtype. Off is the plain matmul + softmax path of the JAX
    `attn_block(..., flash=False)` at any batch, with the scale applied
    after the dot as there; in bf16 it takes the logits and the softmax in
    f32 (q and k upcast: their products are exact in f32) and the second
    product in bf16, as JAX's einsums do."""

    def __init__(self, c: int, flash: bool | None = None):
        super().__init__()
        self.flash = bool(flash)
        self.norm = GroupNorm(c)
        self.q = conv2d(c, c, 1)
        self.k = conv2d(c, c, 1)
        self.v = conv2d(c, c, 1)
        self.proj_out = conv2d(c, c, 1)

    def forward(self, x, flash: bool | None = None):
        b, c, h, w = x.shape
        hn = self.norm(x)
        q = self.q(hn).reshape(b, c, h * w).transpose(1, 2)  # [B, S, C]
        k = self.k(hn).reshape(b, c, h * w)  # [B, C, S]
        v = self.v(hn).reshape(b, c, h * w)  # [B, C, S]
        if self.flash if flash is None else flash:
            out = attention.flash_attention(
                q.contiguous(), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
            ).transpose(1, 2).reshape(b, c, h, w)
        else:
            weights = torch.softmax(torch.bmm(at_least_f32(q), at_least_f32(k)) * (1.0 / math.sqrt(c)), dim=-1)
            out = torch.bmm(v, weights.to(v.dtype).transpose(1, 2)).reshape(b, c, h, w)
        return x + self.proj_out(out)
