# Frozen copy of sgam_neurips22_tpu_torch/models/vqgan/autoencoder.py at commit e4e59b7, kept as the
# benchmark's plain reference: imports point into portbench.reference, and
# the hand kernels are replaced by the plain PyTorch versions of plain_ops.
"""VQGAN Encoder / Decoder (taming architecture) — port of
`sgam_neurips22_tpu/models/vqgan/autoencoder.py`, NCHW.

`DDConfig.compute_dtype` is the activation dtype of the conv stack, with
JAX's cast points: the encoder casts its input to it and returns the
latent in f32 (the codeword search stays f32); the decoder casts its input
to it and returns to f32 before conv_out, so the adaptive GAN weight
differentiates conv_out in f32. Parameters and GroupNorm statistics stay
f32 throughout.

`resolution` is the tracking resolution that places the attention blocks,
exactly as in the reference: for the flagship (resolution 64,
attn_resolutions (16,)) a 256^2 input gets attention at the 64x64 level
(4096 tokens, C=256) and in the two 16x16 mid blocks (C=512).

With `DDConfig.remat`, each down and up level runs under
`torch.utils.checkpoint` when gradients are recorded, as the JAX
`_maybe_remat` wraps each level in `jax.checkpoint`: the policy saves the
outputs of every convolution (JAX's `save_only_these_names("conv_out")`)
and recomputes GroupNorm, swish, attention and the rest on the backward
pass. The mid blocks are not rematerialised, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from portbench.reference.dtypes import COMPUTE_DTYPES, at_least_f32
from portbench.reference.vq_nn import (
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
    """The reference's ddconfig node, plus the JAX package's `remat`,
    `compute_dtype` and `flash_attention`."""

    ch: int = 128
    out_ch: int = 4
    ch_mult: tuple = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple = (16,)
    in_channels: int = 4
    resolution: int = 64
    z_channels: int = 256
    # rematerialise each down/up level on the backward pass, saving only
    # convolution outputs (JAX DDConfig.remat; numerics are identical)
    remat: bool = False
    # activation dtype of the conv stack: "float32" (parity) or "bfloat16"
    compute_dtype: str = "float32"
    # flash attention in every AttnBlock (JAX DDConfig.flash_attention):
    # None or False is the plain path; a caller's `flash=` overrides it per
    # call, as JAX's batched unroll swaps the config (_flash_model_cfg)
    flash_attention: bool | None = None

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r} is not one of {sorted(COMPUTE_DTYPES)}")

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """x in the compute dtype; "float32" leaves x as it is (f32, or
        float64 in a float64 reference run)."""
        return x if self.compute_dtype == "float32" else x.to(COMPUTE_DTYPES[self.compute_dtype])


def _save_convolutions(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _level(level: nn.Module, h: torch.Tensor, flash: bool | None = None) -> torch.Tensor:
    """One down or up level: its blocks (each followed by its attention
    block where the level has them, `flash` overriding its path when not
    None), then its down- or upsampling."""
    for i_block, block in enumerate(level.block):
        h = block(h)
        if len(level.attn):
            h = level.attn[i_block](h, flash)
    resample = getattr(level, "downsample", None) or getattr(level, "upsample", None)
    return h if resample is None else resample(h)


def _run_level(level: nn.Module, h: torch.Tensor, remat: bool, flash: bool | None = None) -> torch.Tensor:
    """_level(level, h, flash), rematerialised on the backward pass when
    `remat` is set and autograd records."""
    if not (remat and torch.is_grad_enabled()):
        return _level(level, h, flash)
    return checkpoint(_level, level, h, flash, use_reentrant=False,
                      context_fn=partial(create_selective_checkpoint_contexts, _save_convolutions))


def _mid(c: int, flash: bool | None) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(c, c)
    mid.attn_1 = AttnBlock(c, flash)
    mid.block_2 = ResnetBlock(c, c)
    return mid


def _run_mid(mid: nn.Module, h: torch.Tensor, flash: bool | None = None) -> torch.Tensor:
    return mid.block_2(mid.attn_1(mid.block_1(h), flash))


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
                    level.attn.append(AttnBlock(block_in, cfg.flash_attention))
            if i_level != len(cfg.ch_mult) - 1:
                level.downsample = Downsample(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = _mid(block_in, cfg.flash_attention)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = conv2d(block_in, cfg.z_channels)
        self.cfg = cfg

    def forward(self, x, flash: bool | None = None):
        """The latent in f32 whatever the compute dtype; `flash` not None
        overrides the attention blocks' path for this call."""
        h = self.conv_in(self.cfg.cast(x))
        for level in self.down:
            h = _run_level(level, h, self.cfg.remat, flash)
        h = _run_mid(self.mid, h, flash)
        return at_least_f32(self.conv_out(swish(self.norm_out(h))))


class Decoder(nn.Module):
    """[B, z_channels, h, w] -> [B, out_ch, h*2^k, w*2^k]."""

    def __init__(self, cfg: DDConfig):
        super().__init__()
        num_res = len(cfg.ch_mult)
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (num_res - 1)
        self.conv_in = conv2d(cfg.z_channels, block_in)
        self.mid = _mid(block_in, cfg.flash_attention)
        up = [None] * num_res
        for i_level in reversed(range(num_res)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in, cfg.flash_attention))
            if i_level != 0:
                level.upsample = Upsample(block_in)
                curr_res *= 2
            up[i_level] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = conv2d(block_in, cfg.out_ch)
        self.cfg = cfg

    def features(self, z, flash: bool | None = None):
        """Everything before conv_out, up to and including the final
        norm + swish (JAX `apply_decoder_features`), back in f32: the
        adaptive GAN weight differentiates w.r.t. conv_out's kernel alone.
        `flash` as in Encoder.forward."""
        h = _run_mid(self.mid, self.conv_in(self.cfg.cast(z)), flash)
        for level in reversed(self.up):
            h = _run_level(level, h, self.cfg.remat, flash)
        return at_least_f32(swish(self.norm_out(h)))

    def forward(self, z, flash: bool | None = None):
        return self.conv_out(self.features(z, flash))
