"""VQ-LPIPS-GAN loss, generator and discriminator sides — port of
`sgam_neurips22_tpu/training/losses.py`.

L1 reconstruction over all 4 channels plus LPIPS on RGB, the
non-saturating generator loss -E[D(xrec)] weighted by the adaptive weight
||grad nll|| / (||grad g|| + 1e-4) at the decoder's final conv kernel, a
hinge (or vanilla) discriminator loss gated by a global-step threshold
(`adopt_weight`), and the codebook loss.

Two rules of the JAX functions that PyTorch does not give for free:
- BatchNorm state. The generator side's discriminator calls run in train
  mode but drop the new running statistics; only `discriminator_loss`
  keeps them (real, then fake). Here the generator side goes through
  `discriminator.apply_keeping_stats`.
- The adaptive weight takes gradients w.r.t. conv_out's kernel alone with
  the decoder features held fixed, which is what `torch.autograd.grad` of
  each loss w.r.t. that kernel computes on the step's own graph.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sgam_neurips22_tpu_torch.training.discriminator import (
    DiscConfig,
    NLayerDiscriminator,
    apply_keeping_stats,
)
from sgam_neurips22_tpu_torch.training.lpips import LPIPS


@dataclass(frozen=True)
class LossConfig:
    disc_start: int = 10_000
    codebook_weight: float = 1.0
    pixelloss_weight: float = 1.0
    disc_num_layers: int = 3
    disc_in_channels: int = 4
    disc_factor: float = 1.0
    disc_weight: float = 0.8
    perceptual_weight: float = 1.0
    disc_ndf: int = 64
    disc_loss: str = "hinge"
    use_discriminative_loss: bool = True
    kernel_width: int = 4

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LossConfig":
        """From a `lossconfig.params` node; keys that are not fields are
        dropped, as in JAX."""
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def disc_config(self) -> DiscConfig:
        return DiscConfig(
            input_nc=self.disc_in_channels, ndf=self.disc_ndf,
            n_layers=self.disc_num_layers, kernel_width=self.kernel_width,
        )


def adopt_weight(weight: float, global_step: int, threshold: int) -> torch.Tensor:
    """0 before `threshold` steps, as a float32 scalar."""
    return torch.tensor(0.0 if global_step < threshold else weight, dtype=torch.float32)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


def _nll(x_dst, xrec, lpips: Optional[LPIPS], cfg: LossConfig):
    """(nll, logged rec_loss, mean LPIPS): mean(|x - xrec| + w_p * LPIPS(rgb)).
    The logged rec_loss is nll itself, as the reference logs it after
    adding the perceptual term."""
    rec = torch.abs(x_dst - xrec)
    if cfg.perceptual_weight > 0 and lpips is not None:
        p = lpips(x_dst[..., :3], xrec[..., :3])  # [B, 1, 1, 1]
        nll = torch.mean(rec + cfg.perceptual_weight * p)
        return nll, nll, torch.mean(p)
    nll = torch.mean(rec)
    return nll, nll, torch.zeros((), dtype=rec.dtype, device=rec.device)


def generator_loss(
    x_dst: torch.Tensor,
    h_pre: torch.Tensor,
    conv_out_weight: torch.Tensor,
    conv_out_bias: torch.Tensor,
    qloss: torch.Tensor,
    global_step: int,
    disc: NLayerDiscriminator,
    lpips: Optional[LPIPS],
    cfg: LossConfig,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Optimizer-0 (autoencoder) loss.

    Args:
      x_dst: [B, H, W, 4] target.
      h_pre: [B, H, W, ch] decoder features before conv_out
        (`VQModel.decode_features`).
      conv_out_weight, conv_out_bias: decoder.conv_out's parameters; the
        weight is the adaptive weight's anchor. A frozen (no-grad) weight is
        differentiated through a detached copy, as the JAX function
        differentiates a stop-gradient copy.
    Returns:
      (loss, xrec [B, H, W, 4], log dict of scalars).
    """
    w = conv_out_weight if conv_out_weight.requires_grad else conv_out_weight.detach().requires_grad_()
    xrec = F.conv2d(h_pre.permute(0, 3, 1, 2), w, conv_out_bias, padding=w.shape[-1] // 2).permute(0, 2, 3, 1)
    nll, rec_log, p_log = _nll(x_dst, xrec, lpips, cfg)
    if cfg.use_discriminative_loss:
        g_loss = -torch.mean(apply_keeping_stats(disc, xrec))
        nll_grad, = torch.autograd.grad(nll, w, retain_graph=True)
        g_grad, = torch.autograd.grad(g_loss, w, retain_graph=True)
        d_weight = torch.linalg.vector_norm(nll_grad) / (torch.linalg.vector_norm(g_grad) + 1e-4)
        d_weight = (torch.clamp(d_weight, 0.0, 1e4) * cfg.disc_weight).detach()
    else:
        g_loss = torch.zeros((), dtype=xrec.dtype, device=xrec.device)
        d_weight = torch.zeros((), dtype=xrec.dtype, device=xrec.device)
    disc_factor = adopt_weight(cfg.disc_factor, global_step, cfg.disc_start).to(xrec.device)
    quant_loss = torch.mean(qloss)
    loss = nll + d_weight * disc_factor * g_loss + cfg.codebook_weight * quant_loss
    log = {
        "total_loss": loss, "quant_loss": quant_loss, "rec_loss": rec_log, "p_loss": p_log,
        "d_weight": d_weight, "disc_factor": disc_factor, "g_loss": g_loss,
    }
    return loss, xrec, {k: v.detach() for k, v in log.items()}


def discriminator_loss(
    x_dst: torch.Tensor,
    xrec: torch.Tensor,
    global_step: int,
    disc: NLayerDiscriminator,
    cfg: LossConfig,
    update_stats: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Optimizer-1 (discriminator) loss on the real, then the fake images,
    both detached, in train mode. With update_stats the running statistics
    move as the JAX function's returned state (real first, then fake);
    without, they stay (the JAX eval step drops that state). Returns
    (loss, log)."""
    apply = disc if update_stats else (lambda x: apply_keeping_stats(disc, x))
    logits_real = apply(x_dst.detach())
    logits_fake = apply(xrec.detach())
    d_fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    disc_factor = adopt_weight(cfg.disc_factor, global_step, cfg.disc_start).to(xrec.device)
    d_loss = disc_factor * d_fn(logits_real, logits_fake)
    log = {"disc_loss": d_loss, "logits_real": torch.mean(logits_real), "logits_fake": torch.mean(logits_fake)}
    return d_loss, {k: v.detach() for k, v in log.items()}
