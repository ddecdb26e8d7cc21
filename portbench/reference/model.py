# Frozen copy of sgam_neurips22_tpu_torch/models/vqgan/model.py at commit e4e59b7, kept as the
# benchmark's plain reference: imports point into portbench.reference, and
# the hand kernels are replaced by the plain PyTorch versions of plain_ops.
"""VQModel, the generative sensing module — port of
`sgam_neurips22_tpu/models/vqgan/model.py`: forward (quantised, or top-k
sampled), and the pieces the training step uses (`decode_features`,
`get_last_layer`). The conv stack runs in `DDConfig.compute_dtype`; conv_in,
quant_conv, post_quant_conv and the codeword distances stay f32, as their
inputs are f32 in JAX too.

Public methods take and return NHWC, as the JAX functions do; the conv
stack inside runs NCHW. Parameter names are the reference state_dict's:
conv_in (5->4 1x1 folding the extrapolation mask in; absent without
use_extrapolation_mask), encoder, decoder,
quant_conv, post_quant_conv, quantize.embedding.weight.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch import nn

from portbench.reference.autoencoder import DDConfig, Decoder, Encoder
from portbench.reference.vq_nn import conv2d
from portbench.reference.quantize import quantize


@dataclass(frozen=True)
class VQModelConfig:
    """The fields of the JAX `VQModelConfig`. With use_extrapolation_mask,
    conv_in folds the extrapolation mask into the input; below
    vq_step_threshold train steps the trainer skips quantisation."""

    ddconfig: DDConfig
    n_embed: int
    embed_dim: int
    phase: str = "codebook"  # 'codebook' | 'conditional_generation'
    use_extrapolation_mask: bool = True
    vq_step_threshold: int = 0
    beta: float = 0.25
    dataset: str = "clevr-infinite"
    depth_range: Optional[tuple] = None

class ForwardResult(NamedTuple):
    xrec: torch.Tensor  # [B, H, W, 4], or [B, S, H, W, 4] with topk
    qloss: torch.Tensor  # scalar codebook loss (0 with topk)
    indices: torch.Tensor  # [B, h, w], or [B, S, h, w] with topk
    pre_quant: torch.Tensor  # [B, h, w, D]
    quant: torch.Tensor  # the latents that were decoded


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class VectorQuantizer(nn.Module):
    """Holds the codebook as `embedding.weight` [n_embed, embed_dim]."""

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)


class VQModel(nn.Module):
    def __init__(self, cfg: VQModelConfig):
        super().__init__()
        self.cfg = cfg
        dd = cfg.ddconfig
        self.conv_in = conv2d(dd.in_channels + 1, dd.in_channels, 1) if cfg.use_extrapolation_mask else None
        self.encoder = Encoder(dd)
        self.decoder = Decoder(dd)
        self.quant_conv = conv2d(dd.z_channels, cfg.embed_dim, 1)
        self.post_quant_conv = conv2d(cfg.embed_dim, dd.z_channels, 1)
        self.quantize = VectorQuantizer(cfg.n_embed, cfg.embed_dim)

    @property
    def codebook(self) -> torch.Tensor:
        return self.quantize.embedding.weight

    def _fold_mask(self, x, extrapolation_mask):
        """NHWC x -> NCHW input with the mask channel folded in by conv_in
        (zeros when no mask is given); x alone without conv_in."""
        if self.conv_in is None:
            return _nchw(x)
        if extrapolation_mask is None:
            m = torch.zeros((*x.shape[:3], 1), dtype=x.dtype, device=x.device)
        else:
            m = extrapolation_mask.to(x.dtype)
            if m.dim() == 3:
                m = m[..., None]
        return self.conv_in(_nchw(torch.cat([x, m], dim=-1)))

    def encode_prequant(self, x, extrapolation_mask=None, flash=None):
        """conv_in -> encoder -> quant_conv: [B, H, W, 4] -> [B, h, w, D].
        `flash` not None overrides `ddconfig.flash_attention` for the call."""
        h = self.encoder(self._fold_mask(x, extrapolation_mask), flash)
        return _nhwc(self.quant_conv(h)).contiguous()

    def decode(self, quant, flash=None):
        """post_quant_conv -> decoder: [B, h, w, D] -> [B, H, W, out_ch]."""
        return _nhwc(self.decoder(self.post_quant_conv(_nchw(quant)), flash))

    def decode_features(self, quant):
        """Decoder features before its conv_out: [B, h, w, D] -> [B, H, W, ch]
        (an NHWC view of the NCHW features)."""
        return _nhwc(self.decoder.features(self.post_quant_conv(_nchw(quant))))

    def get_last_layer(self) -> torch.Tensor:
        """decoder.conv_out.weight, the anchor of the adaptive GAN weight."""
        return self.decoder.conv_out.weight

    def forward(self, x, extrapolation_mask=None, flash=None):
        """Encode -> quantise -> decode; NHWC in and out. The attention
        blocks take `ddconfig.flash_attention`'s path, or `flash`'s where it
        is not None (JAX swaps the model config)."""
        pre_quant = self.encode_prequant(x, extrapolation_mask, flash)
        q = quantize(self.codebook, pre_quant, self.cfg.beta)
        return ForwardResult(self.decode(q.z_q, flash), q.loss, q.indices, pre_quant, q.z_q)

