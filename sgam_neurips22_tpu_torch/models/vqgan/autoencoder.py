"""VQGAN Encoder / Decoder (taming architecture) — port of
`sgam_neurips22_tpu/models/vqgan/autoencoder.py`, f32, NCHW.

`resolution` is the tracking resolution that places the attention blocks,
exactly as in the reference: for the flagship (resolution 64,
attn_resolutions (16,)) a 256^2 input gets attention at the 64x64 level
(4096 tokens, C=256) and in the two 16x16 mid blocks (C=512).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from sgam_neurips22_tpu_torch.models.vqgan.nn import (
    AttnBlock,
    Downsample,
    GroupNorm,
    ResnetBlock,
    Upsample,
    conv2d,
    swish,
)


@dataclass(frozen=True)
class DDConfig:
    """The reference's ddconfig node (f32, no rematerialisation)."""

    ch: int = 128
    out_ch: int = 4
    ch_mult: tuple = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple = (16,)
    in_channels: int = 4
    resolution: int = 64
    z_channels: int = 256


def _mid(c: int) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(c, c)
    mid.attn_1 = AttnBlock(c)
    mid.block_2 = ResnetBlock(c, c)
    return mid


def _run_mid(mid: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return mid.block_2(mid.attn_1(mid.block_1(h)))


class Encoder(nn.Module):
    """[B, in_channels, H, W] -> [B, z_channels, H/2^k, W/2^k]."""

    def __init__(self, cfg: DDConfig):
        super().__init__()
        self.conv_in = conv2d(cfg.in_channels, cfg.ch)
        in_ch_mult = (1,) + tuple(cfg.ch_mult)
        curr_res = cfg.resolution
        self.down = nn.ModuleList()
        block_in = cfg.ch
        for i_level, mult in enumerate(cfg.ch_mult):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_in = cfg.ch * in_ch_mult[i_level]
            block_out = cfg.ch * mult
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = _mid(block_in)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = conv2d(block_in, cfg.z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = _run_mid(self.mid, h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    """[B, z_channels, h, w] -> [B, out_ch, h*2^k, w*2^k]."""

    def __init__(self, cfg: DDConfig):
        super().__init__()
        num_res = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (num_res - 1)
        self.conv_in = conv2d(cfg.z_channels, block_in)
        self.mid = _mid(block_in)
        up = [None] * num_res
        for i_level in reversed(range(num_res)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != 0:
                level.upsample = Upsample(block_in)
                curr_res *= 2
            up[i_level] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = conv2d(block_in, cfg.out_ch)

    def forward(self, z):
        h = _run_mid(self.mid, self.conv_in(z))
        for level in reversed(self.up):
            for i_block, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(swish(self.norm_out(h)))
