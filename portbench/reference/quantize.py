# Frozen copy of sgam_neurips22_tpu_torch/models/vqgan/quantize.py at commit e4e59b7, kept as the
# benchmark's plain reference: imports point into portbench.reference, and
# the hand kernels are replaced by the plain PyTorch versions of plain_ops.
"""Vector quantisation — port of `sgam_neurips22_tpu/models/vqgan/quantize.py`:
nearest-codeword VQ with the straight-through form, and top-k sampling
(the argmin at topk == 1, Gumbel-max draws from a torch.Generator above)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.plain_ops import f32_matmul
from portbench.reference.plain_ops import nearest_codeword


class QuantizeResult(NamedTuple):
    z_q: torch.Tensor  # [B, h, w, D] straight-through quantised latents
    loss: torch.Tensor  # scalar codebook + commitment loss
    indices: torch.Tensor  # [B, h, w] int32 codeword ids


def codeword_distances(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [P, K] = |z|^2 + |e|^2 - 2 z.e in f32, the
    product in full f32 in every matmul precision mode, as JAX pins it
    (`precision=HIGHEST`): TF32 would perturb the ranking."""
    z = z_flat.float()
    e = codebook.float()
    with f32_matmul():
        ze = z @ e.T
    return (z * z).sum(dim=1, keepdim=True) + (e * e).sum(dim=1)[None, :] - 2.0 * ze


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

