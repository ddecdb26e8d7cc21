"""The conditional-generation training step's plain reference: the port's
`training/train_step.py` at commit e4e59b7 for one process and the
configuration the benchmark runs (no k-means, no gradient accumulation, a
constant learning rate), over the frozen copies of the model, LPIPS, the
discriminator and the losses, in float32 with TF32 off (`rounded` below
float32 where the control asks for it).

One step: an autoencoder update (Adam, betas (0.5, 0.9), eps 1e-8) on
L1 + LPIPS + adaptive-weight GAN + codebook loss of the splat
conditioning's reconstruction, then a discriminator update on the hinge
loss of the real and the step's reconstructed images, at the
discriminator's weights before the step. In this phase only conv_in and
the encoder train.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference.conditioning import get_x
from portbench.reference.discriminator import NLayerDiscriminator
from portbench.reference.losses import LossConfig, discriminator_loss, generator_loss
from portbench.reference.lpips import LPIPS
from portbench.reference.model import VQModel
from portbench.reference.quantize import quantize

TRAINABLE = ("conv_in", "encoder")  # the conditional phase's


@dataclass
class State:
    model: VQModel
    disc: NLayerDiscriminator
    lpips: LPIPS
    loss: LossConfig
    opt_ae: torch.optim.Adam
    opt_disc: torch.optim.Adam
    step: int = 0

    @property
    def trainable(self) -> dict:
        return {n: p for n, p in self.model.named_parameters() if n.split(".")[0] in TRAINABLE}


def make_state(model: VQModel, disc: NLayerDiscriminator, lpips: LPIPS, loss: LossConfig, lr: float) -> State:
    """Train mode, the frozen parameters marked, both optimizers with zero moments."""
    model.train()
    disc.train()
    for n, p in model.named_parameters():
        p.requires_grad_(n.split(".")[0] in TRAINABLE)
    trainable = [p for n, p in model.named_parameters() if n.split(".")[0] in TRAINABLE]
    return State(model, disc, lpips, loss,
                 torch.optim.Adam(trainable, lr=lr, betas=(0.5, 0.9), eps=1e-8),
                 torch.optim.Adam(list(disc.parameters()), lr=lr, betas=(0.5, 0.9), eps=1e-8))


def losses(state: State, batch: dict, dataset: str, depth_range):
    """(logs, trainable grads, disc grads) of one step at the state's
    weights; the logs named as the port's train_step names them."""
    cond = get_x(batch, dataset, depth_range=depth_range, collision="nearest")
    return model_losses(state, cond.x, cond.x_dst, cond.extrapolation_mask)


def model_losses(state: State, x, x_dst, mask):
    """`losses` from the conditioning x [B, H, W, 4], its target and mask."""
    model = state.model
    pre = model.encode_prequant(x, mask, flash=False)
    q = quantize(model.codebook, pre, model.cfg.beta)
    h_pre = model.decode_features(q.z_q)
    ae_loss, xrec, ae_log = generator_loss(x_dst, h_pre, model.get_last_layer(), model.decoder.conv_out.bias, q.loss,
                                      state.step, state.disc, state.lpips, state.loss)
    trainable = list(state.trainable.values())
    grads = torch.autograd.grad(ae_loss, trainable, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(trainable, grads)]
    d_loss, d_log = discriminator_loss(x_dst, xrec, state.step, state.disc, state.loss)
    d_grads = list(torch.autograd.grad(d_loss, list(state.disc.parameters())))
    logs = {"aeloss": ae_loss.detach(), "discloss": d_loss.detach(),
            **{f"train/{k}": v for k, v in {**ae_log, **d_log}.items()}}
    return logs, grads, d_grads


def step(state: State, batch: dict, dataset: str, depth_range) -> dict:
    """One step, in place; its logs as floats."""
    logs, grads, d_grads = losses(state, batch, dataset, depth_range)
    for opt, params, gs in ((state.opt_ae, list(state.trainable.values()), grads),
                            (state.opt_disc, list(state.disc.parameters()), d_grads)):
        for p, g in zip(params, gs):
            p.grad = g
        opt.step()
    state.step += 1
    return {k: float(v) for k, v in logs.items()}
