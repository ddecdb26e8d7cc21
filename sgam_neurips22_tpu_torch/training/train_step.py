"""Two-optimizer GAN training step — port of
`sgam_neurips22_tpu/training/train_step.py`, on one device or as one rank
of a data-parallel process group.

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
this step left in its `.grad`.

Options of the JAX `TrainConfig`, each as optax runs it:
- online k-means: `TrainState.kmeans` holds the bookkeeping (timeouts and
  a ring buffer of batch element 0's pre-quantization features), updated
  by every step; the refresh itself runs between steps (`training/kmeans`,
  called by the trainer);
- gradient accumulation (`optax.MultiSteps`): each optimizer's gradients
  are averaged over `accumulate_grad_batches` mini-steps as a running mean
  (acc + (g - acc) / (n + 1)) and applied once, on the last; `step` counts
  mini-steps;
- the LR scheduler: Adam update j (counted from 0) has LR
  learning_rate * schedule(j), the count optax's schedule reads, which
  moves once per applied update; the first update of all has schedule(0)
  (lr_start, 0 by default);
- the pre-VQ passthrough (`use_vq` False): the latents skip quantisation,
  with a zero codebook loss and all-zero indices.

Under a process group (`parallel.distributed.data_group`) the batch is the
rank's rows of the global batch and the step is the JAX step on the
global batch: the discriminator's BatchNorm and the adaptive weight are
global (`discriminator`, `losses`); both optimizers' gradients and the
logs are averaged over the ranks in one bucketed all-reduce before the
updates (torch DDP would not see them: the step takes `torch.autograd.grad`,
which runs none of DDP's hooks), each microbatch's before it is
accumulated, as optax.MultiSteps accumulates global gradients; and the
k-means bookkeeping takes element 0 of the global batch, rank 0's first
row, broadcast to every rank. Every rank then holds the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sgam_neurips22_tpu_torch.core.device import resolve_device
from sgam_neurips22_tpu_torch.core.dtypes import div_scalar
from sgam_neurips22_tpu_torch.core.state_dict import load_into, random_state_dict
from sgam_neurips22_tpu_torch.models.conditioning import get_x
from sgam_neurips22_tpu_torch.models.vqgan.model import VQModel, VQModelConfig
from sgam_neurips22_tpu_torch.models.vqgan.quantize import quantize
from sgam_neurips22_tpu_torch.parallel import distributed
from sgam_neurips22_tpu_torch.training.discriminator import NLayerDiscriminator, init_discriminator
from sgam_neurips22_tpu_torch.training.kmeans import KMeansState, init_kmeans_state, kmeans_bookkeeping
from sgam_neurips22_tpu_torch.training.losses import LossConfig, discriminator_loss, generator_loss
from sgam_neurips22_tpu_torch.training.lpips import LPIPS
from sgam_neurips22_tpu_torch.training.lr_schedule import lambda_warmup_cosine

TRAINABLE_KEYS = {
    "codebook": ("conv_in", "encoder", "decoder", "quant_conv", "post_quant_conv", "quantize"),
    "conditional_generation": ("conv_in", "encoder"),
}


@dataclass(frozen=True)
class OnlineKMeansConfig:
    do_online_kmeans_clustering: bool = False
    start_global_step: int = 0
    online_kmeans_word_timeout: int = 10
    inactive_threshold: float = 0.1
    train_feature_buffer_size: int = 1024
    frequency: int = 1024

    @classmethod
    def from_dict(cls, d: Dict[str, Any] | None) -> "OnlineKMeansConfig":
        if not d:
            return cls()
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class SchedulerConfig:
    """The warmup-cosine LR multiplier, opted into by
    `model.params.lr_scheduler_config` (the reference defines the
    scheduler but trains at a constant LR)."""

    warm_up_steps: int = 10_000
    lr_min: float = 0.0
    lr_max: float = 1.0
    lr_start: float = 0.0
    max_decay_steps: int = 1_000_000

    @classmethod
    def from_dict(cls, d: Dict[str, Any] | None) -> Optional["SchedulerConfig"]:
        if not d:
            return None
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})

    def schedule(self):
        return lambda_warmup_cosine(self.warm_up_steps, self.lr_min, self.lr_max, self.lr_start,
                                    self.max_decay_steps)


@dataclass(frozen=True)
class TrainConfig:
    model: VQModelConfig
    loss: LossConfig
    learning_rate: float = 4.5e-6
    use_vq: bool = True
    online_kmeans: OnlineKMeansConfig = field(default_factory=OnlineKMeansConfig)
    splat_collision: str = "nearest"
    accumulate_grad_batches: int = 1
    lr_scheduler: Optional[SchedulerConfig] = None  # None: constant LR

    @property
    def phase(self) -> str:
        return self.model.phase

    def lr_at(self, step: int) -> float:
        """The LR at a train step, for the log (the optimizer's own LR moves
        with its update count, see `update_lr`)."""
        if self.lr_scheduler is None:
            return self.learning_rate
        return float(np.float32(self.learning_rate) * self.lr_scheduler.schedule()(step))


class GradAccumulator:
    """`optax.MultiSteps(every_k_schedule=k)`'s accumulation: a running mean
    of each tensor's gradient over k mini-steps, returned on the k-th."""

    def __init__(self, params, every_k: int):
        self.every_k = every_k
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in params]

    def add(self, grads) -> Optional[List[torch.Tensor]]:
        """Fold in one mini-step's gradients; the mean on the k-th, else None."""
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.add_(div_scalar(g - a, n + 1))
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step:
            return None
        mean, self.acc = self.acc, [torch.zeros_like(a) for a in self.acc]
        return mean

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd: dict) -> None:
        self.mini_step = int(sd["mini_step"])
        self.acc = [a.to(b.device) for a, b in zip(sd["acc"], self.acc)]


@dataclass
class TrainState:
    model: VQModel
    disc: NLayerDiscriminator
    opt_ae: torch.optim.Adam
    opt_disc: torch.optim.Adam
    step: int = 0
    kmeans: Optional[KMeansState] = None
    accumulators: Optional[Tuple[GradAccumulator, GradAccumulator]] = None  # (ae, disc)


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


def create_train_state(cfg: TrainConfig, seed: int = 0, device: str | torch.device = "cuda",
                       latent_positions: int = 256) -> TrainState:
    """Model and discriminator with seeded random weights (the same for
    every device), frozen parameters marked, the discriminator in train
    mode, both optimizers with zero moments, and, as the config asks, the
    k-means bookkeeping (`latent_positions` features a step) and the
    gradient accumulators."""
    if cfg.phase not in TRAINABLE_KEYS:
        raise ValueError(f"phase {cfg.phase!r} is not one of {sorted(TRAINABLE_KEYS)}")
    dev = resolve_device(device)
    model = VQModel(cfg.model)
    load_into(model, random_state_dict(model, seed))
    disc = init_discriminator(cfg.loss.disc_config, seed + 1)
    model.to(dev).train()
    disc.to(dev).train()
    trainable, frozen = split_params(model, cfg.phase)
    for _, p in frozen:
        p.requires_grad_(False)
    ae_params = [p for _, p in trainable]
    opt_ae, opt_disc = make_optimizers(cfg.learning_rate, ae_params, disc.parameters())
    state = TrainState(model, disc, opt_ae, opt_disc)
    km = cfg.online_kmeans
    if km.do_online_kmeans_clustering:
        state.kmeans = init_kmeans_state(cfg.model.n_embed, km.train_feature_buffer_size, latent_positions,
                                         cfg.model.embed_dim, km.online_kmeans_word_timeout, dev)
    if cfg.accumulate_grad_batches > 1:
        k = cfg.accumulate_grad_batches
        state.accumulators = (GradAccumulator(ae_params, k), GradAccumulator(list(disc.parameters()), k))
    return state


def model_inputs(batch: Dict[str, torch.Tensor], cfg: TrainConfig):
    """(x, x_dst, mask) by phase: the splat conditioning in
    'conditional_generation', the image itself in 'codebook'."""
    if cfg.phase == "conditional_generation":
        cond = get_x(batch, cfg.model.dataset, depth_range=cfg.model.depth_range, collision=cfg.splat_collision)
        return cond.x, cond.x_dst, cond.extrapolation_mask
    x = batch["image"]
    return x, x, None


def _ae_forward(model: VQModel, x, mask, cfg: TrainConfig):
    """(h_pre, qloss, indices, pre_quant): encode, quantise (or pass the
    latents through when `cfg.use_vq` is off), decoder features."""
    pre_quant = model.encode_prequant(x, mask)
    if cfg.use_vq:
        q = quantize(model.codebook, pre_quant, cfg.model.beta)
        latents, qloss, indices = q.z_q, q.loss, q.indices
    else:
        latents = pre_quant
        qloss = torch.zeros((), dtype=pre_quant.dtype, device=pre_quant.device)
        indices = torch.zeros(pre_quant.shape[:3], dtype=torch.int32, device=pre_quant.device)
    return model.decode_features(latents), qloss, indices, pre_quant


def _generator_loss(model: VQModel, disc, lpips, x_dst, h_pre, qloss, step: int, cfg: TrainConfig):
    """(loss, xrec, log) of `generator_loss` at the model's conv_out."""
    return generator_loss(x_dst, h_pre, model.get_last_layer(), model.decoder.conv_out.bias, qloss, step,
                          disc, lpips, cfg.loss)


def _ae_loss(model: VQModel, disc, lpips, x, x_dst, mask, step: int, cfg: TrainConfig):
    """(loss, xrec, indices, log) of the autoencoder at the current weights."""
    h_pre, qloss, indices, _ = _ae_forward(model, x, mask, cfg)
    loss, xrec, log = _generator_loss(model, disc, lpips, x_dst, h_pre, qloss, step, cfg)
    return loss, xrec, indices, log


def _update(opt: torch.optim.Optimizer, params, grads, accumulator: Optional[GradAccumulator], step: int,
            cfg: TrainConfig) -> None:
    """One optimizer's share of a step: fold the gradients into the
    accumulator, if any, and apply an Adam update when one is due, at the
    LR of its update count."""
    if accumulator is not None:
        grads = accumulator.add(grads)
        if grads is None:
            return
    if cfg.lr_scheduler is not None:
        n_updates = step // cfg.accumulate_grad_batches  # updates applied before this one
        lr = float(np.float32(cfg.learning_rate) * cfg.lr_scheduler.schedule()(n_updates))
        for group in opt.param_groups:
            group["lr"] = lr
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
    group = distributed.data_group()
    x, x_dst, mask = model_inputs(batch, cfg)
    acc_ae, acc_disc = state.accumulators or (None, None)

    # optimizer 0: the autoencoder
    trainable = [p for _, p in split_params(state.model, cfg.phase)[0]]
    h_pre, qloss, indices, pre_quant = _ae_forward(state.model, x, mask, cfg)
    ae_loss, xrec, ae_log = _generator_loss(state.model, state.disc, lpips, x_dst, h_pre, qloss, step, cfg)
    grads = torch.autograd.grad(ae_loss, trainable, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainable, grads)]

    # optimizer 1: the discriminator, at its weights before this step
    d_loss, d_log = discriminator_loss(x_dst, xrec, step, state.disc, cfg.loss)
    disc_params = list(state.disc.parameters())
    d_grads = list(torch.autograd.grad(d_loss, disc_params))

    logs = {"aeloss": ae_loss.detach(), "discloss": d_loss.detach()}
    logs.update({f"train/{k}": v for k, v in ae_log.items()})
    logs.update({f"train/{k}": v for k, v in d_log.items()})
    if group is not None:
        values = torch.stack([v.float() for v in logs.values()])
        distributed.all_reduce_mean_([*grads, *d_grads, values], group)
        logs = dict(zip(logs, values.unbind()))
    _update(state.opt_ae, trainable, grads, acc_ae, step, cfg)
    _update(state.opt_disc, disc_params, d_grads, acc_disc, step, cfg)

    state.step += 1
    if state.kmeans is not None:
        row0 = [indices[0].contiguous(), pre_quant[0].detach().contiguous()]
        distributed.broadcast_tensors_(row0, group=group)  # element 0 of the global batch: rank 0's
        kmeans_bookkeeping(state.kmeans, *row0, cfg.online_kmeans.online_kmeans_word_timeout)
        logs["train/codebook_active_percentage"] = torch.mean((state.kmeans.timeout > 0).float())
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
        h_pre, qloss, indices, _ = _ae_forward(state.model, x, mask, cfg)
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
