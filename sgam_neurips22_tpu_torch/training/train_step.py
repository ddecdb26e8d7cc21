"""Two-optimizer GAN training step — port of
`sgam_neurips22_tpu/training/train_step.py` (one device, f32).

One step: (0) an autoencoder update on L1 + LPIPS + adaptive-weight GAN +
codebook loss, then (1) a discriminator update on the hinge loss of the
real and the step's (pre-update) reconstructed images. Both optimizers are
Adam with betas (0.5, 0.9) and eps 1e-8, the update of `optax.adam`.

Phases (reference configure_optimizers):
- 'codebook': the input is the RGB-D image itself and every model
  parameter trains;
- 'conditional_generation': the input is the splat conditioning of
  `models.conditioning.get_x`, and only conv_in and the encoder train. The
  decoder, quant_conv, post_quant_conv and the codebook are frozen
  (requires_grad False), yet the gradient reaches the encoder through the
  decoder and the straight-through quantiser.

Unlike the JAX function, the state is updated in place: `train_step`
returns the same `TrainState`, with each trainable parameter's gradient of
this step left in its `.grad`. Online k-means, gradient accumulation and
the LR scheduler are not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from sgam_neurips22_tpu_torch.core.device import resolve_device
from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
from sgam_neurips22_tpu_torch.models.conditioning import get_x
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel, VQModelConfig
from sgam_neurips22_tpu_torch.models.vqgan.quantize import quantize
from sgam_neurips22_tpu_torch.training.discriminator import NLayerDiscriminator, init_discriminator
from sgam_neurips22_tpu_torch.training.losses import LossConfig, discriminator_loss, generator_loss
from sgam_neurips22_tpu_torch.training.lpips import LPIPS

TRAINABLE_KEYS = {
    "codebook": ("conv_in", "encoder", "decoder", "quant_conv", "post_quant_conv", "quantize"),
    "conditional_generation": ("conv_in", "encoder"),
}


@dataclass(frozen=True)
class TrainConfig:
    model: VQModelConfig
    loss: LossConfig
    learning_rate: float = 4.5e-6
    # not ported yet: each raises in create_train_state when set
    do_online_kmeans_clustering: bool = False
    accumulate_grad_batches: int = 1
    lr_scheduler: Optional[object] = None

    @property
    def phase(self) -> str:
        return self.model.phase


@dataclass
class TrainState:
    model: VQModel
    disc: NLayerDiscriminator
    opt_ae: torch.optim.Adam
    opt_disc: torch.optim.Adam
    step: int = 0


def split_params(model: VQModel, phase: str):
    """(trainable, frozen) lists of (name, parameter) by top-level module."""
    keys = TRAINABLE_KEYS[phase]
    params = list(model.named_parameters())
    trainable = [(n, p) for n, p in params if n.split(".")[0] in keys]
    frozen = [(n, p) for n, p in params if n.split(".")[0] not in keys]
    return trainable, frozen


def make_optimizers(lr: float, ae_params, disc_params):
    """Adam (betas (0.5, 0.9), eps 1e-8) for the autoencoder and for the
    discriminator."""
    return (torch.optim.Adam(list(ae_params), lr=lr, betas=(0.5, 0.9), eps=1e-8),
            torch.optim.Adam(list(disc_params), lr=lr, betas=(0.5, 0.9), eps=1e-8))


def _check_ported(cfg: TrainConfig) -> None:
    if cfg.do_online_kmeans_clustering:
        raise NotImplementedError("online k-means is not ported yet (ROADMAP.md queue (d): kmeans.py)")
    if cfg.accumulate_grad_batches != 1:
        raise NotImplementedError("gradient accumulation is not ported yet (ROADMAP.md queue (d): trainer.py)")
    if cfg.lr_scheduler is not None:
        raise NotImplementedError("the LR scheduler is not ported yet (ROADMAP.md queue (d): lr_schedule.py)")
    if cfg.phase not in TRAINABLE_KEYS:
        raise ValueError(f"phase {cfg.phase!r} is not one of {sorted(TRAINABLE_KEYS)}")


def create_train_state(cfg: TrainConfig, seed: int = 0, device: str | torch.device = "cuda") -> TrainState:
    """Model and discriminator with seeded random weights (the same for
    every device), frozen parameters marked, the discriminator in train
    mode, and both optimizers with zero moments."""
    _check_ported(cfg)
    dev = resolve_device(device)
    model = VQModel(cfg.model)
    load_into(model, random_state_dict(model, seed))
    disc = init_discriminator(cfg.loss.disc_config, seed + 1)
    model.to(dev).train()
    disc.to(dev).train()
    trainable, frozen = split_params(model, cfg.phase)
    for _, p in frozen:
        p.requires_grad_(False)
    opt_ae, opt_disc = make_optimizers(cfg.learning_rate, (p for _, p in trainable), disc.parameters())
    return TrainState(model, disc, opt_ae, opt_disc)


def model_inputs(batch: Dict[str, torch.Tensor], cfg: TrainConfig):
    """(x, x_dst, mask) by phase: the splat conditioning in
    'conditional_generation', the image itself in 'codebook'."""
    if cfg.phase == "conditional_generation":
        cond = get_x(batch, cfg.model.dataset, depth_range=cfg.model.depth_range)
        return cond.x, cond.x_dst, cond.extrapolation_mask
    x = batch["image"]
    return x, x, None


def _ae_forward(model: VQModel, x, mask, cfg: TrainConfig):
    """(h_pre, qloss, indices): encode, quantise, decoder features."""
    q = quantize(model.codebook, model.encode_prequant(x, mask), cfg.model.beta)
    return model.decode_features(q.z_q), q.loss, q.indices


def _generator_loss(model: VQModel, disc, lpips, x_dst, h_pre, qloss, step: int, cfg: TrainConfig):
    """(loss, xrec, log) of `generator_loss` at the model's conv_out."""
    return generator_loss(x_dst, h_pre, model.get_last_layer(), model.decoder.conv_out.bias, qloss, step,
                          disc, lpips, cfg.loss)


def _ae_loss(model: VQModel, disc, lpips, x, x_dst, mask, step: int, cfg: TrainConfig):
    """(loss, xrec, indices, log) of the autoencoder at the current weights."""
    h_pre, qloss, indices = _ae_forward(model, x, mask, cfg)
    loss, xrec, log = _generator_loss(model, disc, lpips, x_dst, h_pre, qloss, step, cfg)
    return loss, xrec, indices, log


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    lpips: Optional[LPIPS],
    cfg: TrainConfig,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One full training step (autoencoder update, then discriminator
    update) on a batch of tensors on the state's device. Returns the state
    (updated in place) and the logs, 0-d tensors on that device."""
    step = state.step
    x, x_dst, mask = model_inputs(batch, cfg)

    # optimizer 0: the autoencoder
    trainable = [p for _, p in split_params(state.model, cfg.phase)[0]]
    ae_loss, xrec, _, ae_log = _ae_loss(state.model, state.disc, lpips, x, x_dst, mask, step, cfg)
    grads = torch.autograd.grad(ae_loss, trainable, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainable, grads)]
    _apply(state.opt_ae, trainable, grads)

    # optimizer 1: the discriminator, at its weights before this step
    d_loss, d_log = discriminator_loss(x_dst, xrec, step, state.disc, cfg.loss)
    disc_params = list(state.disc.parameters())
    _apply(state.opt_disc, disc_params, torch.autograd.grad(d_loss, disc_params))

    state.step += 1
    logs = {"aeloss": ae_loss.detach(), "discloss": d_loss.detach()}
    logs.update({f"train/{k}": v for k, v in ae_log.items()})
    logs.update({f"train/{k}": v for k, v in d_log.items()})
    return state, logs


def eval_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    lpips: Optional[LPIPS],
    cfg: TrainConfig,
) -> Dict[str, torch.Tensor]:
    """Validation losses and rgb / disparity L1, leaving the state as it
    was (the discriminator's running statistics included)."""
    with torch.no_grad():
        x, x_dst, mask = model_inputs(batch, cfg)
        h_pre, qloss, indices = _ae_forward(state.model, x, mask, cfg)
    with torch.enable_grad():  # the adaptive weight differentiates w.r.t. conv_out's kernel
        ae_loss, xrec, ae_log = _generator_loss(state.model, state.disc, lpips, x_dst, h_pre, qloss, state.step, cfg)
    with torch.no_grad():
        _, d_log = discriminator_loss(x_dst, xrec, state.step, state.disc, cfg.loss, update_stats=False)
        logs = {f"val/{k}": v for k, v in {**ae_log, **d_log}.items()}
        logs["val/aeloss"] = ae_loss.detach()
        logs["val/rgb_l1"] = torch.mean(torch.abs(xrec[..., :3] - x_dst[..., :3]))
        logs["val/disparity_l1"] = torch.mean(torch.abs(xrec[..., 3:] - x_dst[..., 3:]))
        logs["val/indices"] = indices
    return logs
