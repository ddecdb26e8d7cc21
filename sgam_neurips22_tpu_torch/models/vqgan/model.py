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

from sgam_neurips22_tpu_torch.models.vqgan.autoencoder import DDConfig, Decoder, Encoder
from sgam_neurips22_tpu_torch.models.vqgan.nn import conv2d
from sgam_neurips22_tpu_torch.models.vqgan.quantize import quantize, quantize_topk


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

    @classmethod
    def from_config(cls, model_params: dict, data_params: dict | None = None) -> "VQModelConfig":
        """From a reference-schema YAML node (model.params, data.params)."""
        data_params = data_params or {}
        return cls(
            ddconfig=DDConfig.from_dict(dict(model_params["ddconfig"])),
            n_embed=model_params["n_embed"],
            embed_dim=model_params["embed_dim"],
            phase=model_params.get("phase", "codebook"),
            use_extrapolation_mask=model_params.get("use_extrapolation_mask", True),
            vq_step_threshold=model_params.get("vq_step_threshold", 0),
            dataset=data_params.get("dataset", "clevr-infinite"),
            depth_range=tuple(data_params["depth_range"]) if "depth_range" in data_params else None,
        )


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

    def decode_code(self, indices, flash=None):
        """Codeword indices [B, h, w] -> image [B, H, W, out_ch] (reference
        model.py:136-139)."""
        return self.decode(self.codebook[indices], flash)

    def decode_features(self, quant):
        """Decoder features before its conv_out: [B, h, w, D] -> [B, H, W, ch]
        (an NHWC view of the NCHW features)."""
        return _nhwc(self.decoder.features(self.post_quant_conv(_nchw(quant))))

    def get_last_layer(self) -> torch.Tensor:
        """decoder.conv_out.weight, the anchor of the adaptive GAN weight."""
        return self.decoder.conv_out.weight

    def forward(self, x, extrapolation_mask=None, topk=None, sample_number=1, generator=None,
                topk_position0_bug=False, flash=None, gumbel=None):
        """Encode -> quantise (topk None) or sample (`quantize_topk`, with
        the mask and `generator` as JAX passes its mask and rng, or with
        the Gumbel noise `gumbel` [P, sample_number, topk] itself, as an
        exported step takes it) -> decode; NHWC in and out. With topk,
        each of the `sample_number` latents is decoded (folded into the
        batch) and xrec is [B, S, H, W, out_ch].
        The attention blocks take `ddconfig.flash_attention`'s path, or
        `flash`'s where it is not None (JAX swaps the model config)."""
        pre_quant = self.encode_prequant(x, extrapolation_mask, flash)
        if topk is None:
            q = quantize(self.codebook, pre_quant, self.cfg.beta)
            return ForwardResult(self.decode(q.z_q, flash), q.loss, q.indices, pre_quant, q.z_q)
        s = quantize_topk(self.codebook, pre_quant, topk, sample_number, extrapolation_mask,
                          position0_bug=topk_position0_bug, generator=generator, gumbel=gumbel)
        b, n = s.z_q.shape[:2]
        xrec = self.decode(s.z_q.reshape(b * n, *s.z_q.shape[2:]), flash)
        xrec = xrec.reshape(b, n, *xrec.shape[1:])
        return ForwardResult(xrec, torch.zeros((), device=x.device), s.indices, pre_quant, s.z_q)


def decode_code(model: VQModel, indices: torch.Tensor) -> torch.Tensor:
    """Indices -> image, JAX's `decode_code(params, cfg, indices)` over a
    VQModel (reference model.py:136-139)."""
    return model.decode_code(indices)
