"""Vector quantisation — port of `sgam_neurips22_tpu/models/vqgan/quantize.py`:
nearest-codeword VQ with the straight-through form, and top-k sampling
for topk == 1 (deterministic argmin)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from sgam_neurips22_tpu_torch.ops.vq import nearest_codeword


class QuantizeResult(NamedTuple):
    z_q: torch.Tensor  # [B, h, w, D] straight-through quantised latents
    loss: torch.Tensor  # scalar codebook + commitment loss
    indices: torch.Tensor  # [B, h, w] int32 codeword ids


class TopKSampleResult(NamedTuple):
    z_q: torch.Tensor  # [B, S, h, w, D]
    indices: torch.Tensor  # [B, S, h, w]


def codeword_distances(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [P, K] = |z|^2 + |e|^2 - 2 z.e in f32."""
    z = z_flat.float()
    e = codebook.float()
    return (z * z).sum(dim=1, keepdim=True) + (e * e).sum(dim=1)[None, :] - 2.0 * (z @ e.T)


def nearest_codeword_indices(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_k ||z - e_k||^2 per row, through `ops.vq.nearest_codeword`
    (the CUDA kernel on the card)."""
    return nearest_codeword(z_flat, codebook)[0]


def quantize(codebook: torch.Tensor, z: torch.Tensor, beta: float = 0.25) -> QuantizeResult:
    """Straight-through VQ of z [B, h, w, D] (NHWC) against codebook [K, D]."""
    b, h, w, d = z.shape
    indices = nearest_codeword_indices(z.reshape(-1, d).contiguous(), codebook).reshape(b, h, w)
    z_q = codebook[indices.long()].to(z.dtype)
    loss = torch.mean((z_q.detach() - z) ** 2) + beta * torch.mean((z_q - z.detach()) ** 2)
    z_q = z + (z_q - z).detach()
    return QuantizeResult(z_q, loss, indices)


def quantize_topk(
    codebook: torch.Tensor,
    z: torch.Tensor,
    topk: int,
    sample_number: int = 1,
    position0_bug: bool = False,
) -> TopKSampleResult:
    """Top-k codeword sampling; only topk == 1 (the argmin) is ported."""
    if topk != 1 or position0_bug:
        raise NotImplementedError(
            "quantize_topk: only topk=1 is ported (ROADMAP.md, queue item (b): "
            "topk>1 sampling)"
        )
    b, h, w, d = z.shape
    idx = nearest_codeword_indices(z.reshape(-1, d).contiguous(), codebook)
    sampled = idx.reshape(b, 1, h, w).expand(b, sample_number, h, w)
    return TopKSampleResult(codebook[sampled.long()].to(z.dtype), sampled)
