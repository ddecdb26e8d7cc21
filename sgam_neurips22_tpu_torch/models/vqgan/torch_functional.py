"""torch-functional implementation of the VQGAN blocks — the port's own
copy of `sgam_neurips22_tpu/models/vqgan/torch_functional.py`, with the
port's `DDConfig`.

The same architecture spec as models/vqgan (GroupNorm(32,1e-6) -> silu ->
3x3 conv ResnetBlocks, single-head AttnBlocks, asymmetric-pad downsample,
nearest-x2 upsample), written with torch.nn.functional ops against a
reference-layout state_dict (OIHW conv kernels, the names of the
reference's modules), independent of the port's `nn.Module`s.

The oracle of `parity_check`'s cross-check: it runs the encoder and
decoder from a `.ckpt`'s state_dict on the CPU in f32, as the JAX tool's
oracle does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sgam_neurips22_tpu_torch.models.vqgan.autoencoder import DDConfig


def t(x):  # NHWC numpy -> NCHW torch
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).contiguous()


def un_t(x):  # NCHW torch -> NHWC numpy
    return x.permute(0, 2, 3, 1).numpy()


def conv_w(sd, name):  # stored OIHW by the exporter
    return torch.from_numpy(np.ascontiguousarray(sd[f"{name}.weight"]))


def conv_b(sd, name):
    return torch.from_numpy(np.ascontiguousarray(sd[f"{name}.bias"]))


def torch_gn(x, sd, name):
    return F.group_norm(
        x, 32,
        torch.from_numpy(sd[f"{name}.weight"]),
        torch.from_numpy(sd[f"{name}.bias"]),
        eps=1e-6,
    )


def torch_resnet_block(x, sd, prefix=""):
    """Reference ResnetBlock semantics (diffusionmodules/model.py:117-137)."""
    p = (prefix + ".") if prefix else ""
    h = torch_gn(x, sd, f"{p}norm1")
    h = h * torch.sigmoid(h)
    h = F.conv2d(h, conv_w(sd, f"{p}conv1"), conv_b(sd, f"{p}conv1"), padding=1)
    h = torch_gn(h, sd, f"{p}norm2")
    h = h * torch.sigmoid(h)
    h = F.conv2d(h, conv_w(sd, f"{p}conv2"), conv_b(sd, f"{p}conv2"), padding=1)
    if f"{p}nin_shortcut.weight" in sd:
        x = F.conv2d(x, conv_w(sd, f"{p}nin_shortcut"), conv_b(sd, f"{p}nin_shortcut"))
    return x + h


def torch_attn_block(x, sd, prefix=""):
    """Reference AttnBlock semantics (diffusionmodules/model.py:168-192)."""
    p = (prefix + ".") if prefix else ""
    h = torch_gn(x, sd, f"{p}norm")
    q = F.conv2d(h, conv_w(sd, f"{p}q"), conv_b(sd, f"{p}q"))
    k = F.conv2d(h, conv_w(sd, f"{p}k"), conv_b(sd, f"{p}k"))
    v = F.conv2d(h, conv_w(sd, f"{p}v"), conv_b(sd, f"{p}v"))
    b, c, hh, ww = q.shape
    qf = q.reshape(b, c, hh * ww).permute(0, 2, 1)
    kf = k.reshape(b, c, hh * ww)
    w_ = torch.bmm(qf, kf) * (c ** -0.5)
    w_ = torch.softmax(w_, dim=2)
    vf = v.reshape(b, c, hh * ww)
    out = torch.bmm(vf, w_.permute(0, 2, 1)).reshape(b, c, hh, ww)
    out = F.conv2d(out, conv_w(sd, f"{p}proj_out"), conv_b(sd, f"{p}proj_out"))
    return x + out


def torch_encoder(x, sd, cfg: DDConfig):
    """Reference Encoder dataflow (diffusionmodules/model.py:405-433)."""
    h = F.conv2d(x, conv_w(sd, "conv_in"), conv_b(sd, "conv_in"), padding=1)
    num_res = len(cfg.ch_mult)
    for i in range(num_res):
        for b in range(cfg.num_res_blocks):
            h = torch_resnet_block(h, sd, f"down.{i}.block.{b}")
            if f"down.{i}.attn.{b}.norm.weight" in sd:
                h = torch_attn_block(h, sd, f"down.{i}.attn.{b}")
        if i != num_res - 1:
            h = F.pad(h, (0, 1, 0, 1))
            h = F.conv2d(
                h, conv_w(sd, f"down.{i}.downsample.conv"),
                conv_b(sd, f"down.{i}.downsample.conv"), stride=2,
            )
    h = torch_resnet_block(h, sd, "mid.block_1")
    h = torch_attn_block(h, sd, "mid.attn_1")
    h = torch_resnet_block(h, sd, "mid.block_2")
    h = torch_gn(h, sd, "norm_out")
    h = h * torch.sigmoid(h)
    return F.conv2d(h, conv_w(sd, "conv_out"), conv_b(sd, "conv_out"), padding=1)


def torch_decoder(z, sd, cfg: DDConfig):
    """Reference Decoder dataflow (diffusionmodules/model.py:508-539)."""
    h = F.conv2d(z, conv_w(sd, "conv_in"), conv_b(sd, "conv_in"), padding=1)
    h = torch_resnet_block(h, sd, "mid.block_1")
    h = torch_attn_block(h, sd, "mid.attn_1")
    h = torch_resnet_block(h, sd, "mid.block_2")
    num_res = len(cfg.ch_mult)
    for i in reversed(range(num_res)):
        for b in range(cfg.num_res_blocks + 1):
            h = torch_resnet_block(h, sd, f"up.{i}.block.{b}")
            if f"up.{i}.attn.{b}.norm.weight" in sd:
                h = torch_attn_block(h, sd, f"up.{i}.attn.{b}")
        if i != 0:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = F.conv2d(
                h, conv_w(sd, f"up.{i}.upsample.conv"),
                conv_b(sd, f"up.{i}.upsample.conv"), padding=1,
            )
    h = torch_gn(h, sd, "norm_out")
    h = h * torch.sigmoid(h)
    return F.conv2d(h, conv_w(sd, "conv_out"), conv_b(sd, "conv_out"), padding=1)


