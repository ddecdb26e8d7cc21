"""Vector quantisation — port of `sgam_neurips22_tpu/models/vqgan/quantize.py`:
nearest-codeword VQ with the straight-through form, and top-k sampling
(the argmin at topk == 1, Gumbel-max draws from a torch.Generator above)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from sgam_neurips22_tpu_torch.core.device import f32_matmul
from sgam_neurips22_tpu_torch.ops.vq import nearest_codeword


class QuantizeResult(NamedTuple):
    z_q: torch.Tensor  # [B, h, w, D] straight-through quantised latents
    loss: torch.Tensor  # scalar codebook + commitment loss
    indices: torch.Tensor  # [B, h, w] int32 codeword ids


class TopKSampleResult(NamedTuple):
    z_q: torch.Tensor  # [B, S, h, w, D]
    indices: torch.Tensor  # [B, S, h, w]


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


def resize_mask_nearest(mask: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Nearest-neighbour resize of mask [B, H, W, ...] to [B, h_out, w_out,
    ...], as torch's F.interpolate(mode='nearest'): out[i] = in[floor(i *
    H / h_out)], the index computed in f32 as JAX computes it."""
    _, h_in, w_in = mask.shape[:3]
    ys = torch.floor(torch.arange(h_out, device=mask.device) * (h_in / h_out)).long()
    xs = torch.floor(torch.arange(w_out, device=mask.device) * (w_in / w_out)).long()
    return mask[:, ys][:, :, xs]


class RowShard(NamedTuple):
    """A generator that draws one rank's rows of a sharded batch: the
    draw of all `count` ranks' rows at once, of which this rank keeps
    block `index`. A scene-sharded unroll draws each scene's noise as the
    unsharded unroll does (JAX's mesh draws one global array from one key)."""

    generator: torch.Generator
    index: int
    count: int


def gumbel_noise(shape, generator: torch.Generator | RowShard, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)) in f32, U uniform on [tiny, 1)
    from `generator`, as jax.random.gumbel draws it from its key; from a
    RowShard, its rows of the whole batch's draw."""
    if isinstance(generator, RowShard):
        rows = shape[0]
        full = gumbel_noise((rows * generator.count, *shape[1:]), generator.generator, device)
        return full[generator.index * rows: (generator.index + 1) * rows]
    u = torch.rand(shape, generator=generator, device=device).clamp_min_(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_slots(neg_topk: torch.Tensor, gumbel: torch.Tensor, temperature: float = 1.0,
                 position0_bug: bool = False) -> torch.Tensor:
    """Categorical draws [P, S] of top-k slots by the Gumbel-max trick:
    argmax over k of logits[:, None, :] + gumbel [P, S, k], with logits
    -d/T over each position's k nearest distances (neg_topk [P, k]), as
    jax.random.categorical computes it. With position0_bug every position
    draws from position 0's logits and the temperature is ignored (the
    reference's `min_encoding_dist[0]`)."""
    logits = neg_topk[:1].expand_as(neg_topk) if position0_bug else neg_topk / temperature
    return torch.argmax(logits[:, None, :] + gumbel, dim=-1)  # first maximum, as jnp.argmax


def quantize_topk(
    codebook: torch.Tensor,
    z: torch.Tensor,
    topk: int,
    sample_number: int = 1,
    extrapolation_mask: torch.Tensor | None = None,
    temperature: float = 1.0,
    position0_bug: bool = False,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> TopKSampleResult:
    """Top-k codeword sampling for z [B, h, w, D] (reference
    quantize.py:344-381).

    topk == 1 is the argmin through `ops.vq.nearest_codeword` (no draw).
    Otherwise each position takes its k nearest codewords (plain f32
    distances and torch.topk, as JAX takes `codeword_distances` and
    lax.top_k) and draws `sample_number` of them from softmax(-d / T)
    (`sample_slots`); positions visible in the warped conditioning
    (extrapolation_mask [B, H, W(, 1)] False at the nearest image pixel)
    take the nearest codeword instead.

    Args:
      generator: draws the Gumbel noise [P, S, k]; or pass `gumbel` itself
        (a test feeds JAX's jax.random.gumbel(rng, (P, S, k))).
    Returns:
      z_q [B, S, h, w, D] (no straight-through), indices [B, S, h, w] int32.
    """
    b, h, w, d = z.shape
    if topk == 1:
        idx = nearest_codeword_indices(z.reshape(-1, d).contiguous(), codebook)
        sampled = idx.reshape(b, 1, h, w).expand(b, sample_number, h, w)
        return TopKSampleResult(codebook[sampled.long()].to(z.dtype), sampled)
    neg_topk, top_idx = torch.topk(-codeword_distances(z.reshape(-1, d), codebook), topk, dim=1)  # nearest first
    if gumbel is None:
        if generator is None:
            raise ValueError("topk sampling needs a generator (or the Gumbel noise itself)")
        gumbel = gumbel_noise((b * h * w, sample_number, topk), generator, z.device)
    sampled = torch.take_along_dim(top_idx, sample_slots(neg_topk, gumbel, temperature, position0_bug), dim=1)
    if extrapolation_mask is not None:
        m = extrapolation_mask[..., 0] if extrapolation_mask.dim() == 4 else extrapolation_mask
        free = resize_mask_nearest(m.float(), h, w).reshape(-1, 1) > 0.0  # True = sample; False = argmin
        sampled = torch.where(free, sampled, top_idx[:, :1])
    sampled = sampled.reshape(b, h, w, sample_number).permute(0, 3, 1, 2)  # [B, S, h, w]
    return TopKSampleResult(codebook[sampled].to(z.dtype), sampled.to(torch.int32))


def remap_to_used(indices: torch.Tensor, used: torch.Tensor, generator: torch.Generator | None = None,
                  unknown_index: int | str = "random") -> torch.Tensor:
    """Full-codebook indices mapped onto the reduced table `used`
    (reference quantize.py:251-263): an index's position in `used`, and for
    an index not in it a random position drawn from `generator` (JAX takes
    a key) or the fixed `unknown_index`."""
    match = indices[..., None] == used  # [..., n_used]
    new = match.int().argmax(-1)  # first match, as jnp.argmax
    unknown = ~match.any(-1)
    if unknown_index == "random":
        if generator is None:
            raise ValueError("unknown_index='random' needs a torch.Generator")
        fill = torch.randint(0, used.shape[0], indices.shape, generator=generator,
                             device=generator.device).to(indices.device)
    else:
        fill = torch.full_like(new, int(unknown_index))
    return torch.where(unknown, fill, new)


def unmap_to_all(indices: torch.Tensor, used: torch.Tensor) -> torch.Tensor:
    """The inverse of remap_to_used (reference quantize.py:265-273); an
    index past the used table reads entry 0."""
    return used[torch.where(indices >= used.shape[0], 0, indices)]


def embed_code(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Codewords of `indices` [...] -> [..., D] (reference quantize.py:327-342)."""
    return codebook[indices]


def update_codebook(codebook: torch.Tensor, features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """A copy of `codebook` with rows `indices` replaced by `features`
    (the online k-means refresh, reference quantize.py:321-325)."""
    out = codebook.clone()
    out[indices] = features.to(codebook.dtype)
    return out


def codebook_usage(indices: torch.Tensor, n_embed: int) -> torch.Tensor:
    """[n_embed] int32 count of each codeword's uses among `indices`."""
    return torch.bincount(indices.reshape(-1).long(), minlength=n_embed).to(torch.int32)
