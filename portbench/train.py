"""Cells of kind "train": the port's conditional-generation training step
(`training.train_step.train_step`) on batches made on the device from the
seed, each step a new batch.

Set-up builds one training state with the benchmark's weights and drives
it through its first `check_steps` steps, the window's own call on the
window's own feed (batches 0, 1, 2, ...); those steps warm every shape.
The window then runs further steps on the same state. `train_images_per_s`
counts the images of every step the window ran over the window's whole
time; each step ends with a synchronize.

The check: the plain reference (`reference/train.py`, float32, TF32 off)
runs the first `check_steps` steps from the same weights on the same
batches, after the window and with the program freed. Compared: the first
step's latents by the codewords they pick (`_code_gap`), its losses (the
gap over the reference's magnitude), each row's share of its gradient at
the latents (`_row_gap`: a step that leaves rows out of its loss reads 1),
the norm of each trainable tensor's first gradient as the optimizer got it
(Adam's first moment after step 1 over 1 - beta1) by the median tensor,
and the norm of each trainable tensor's change after the checked steps by
its worst tensor. A tensor's gap is the gap between the program's norm and
the reference's, over the larger of the reference's norm of that tensor
and of the median tensor. Tensors whose reference gradient is under a
thousandth of the median tensor's are left out of the gradient and change
readings (their moves are rounding). The first gradient is read by the
median tensor because its worst tensor is a cancelling sum (PERF.md); its
worst tensor's gap is kept beside it as a reading.
"""
from __future__ import annotations

import time

import torch

from portbench import program, traffic as gen, weights, work
from portbench.reference import autoencoder as ref_autoencoder
from portbench.reference import discriminator as ref_disc
from portbench.reference import losses as ref_losses
from portbench.reference import lpips as ref_lpips
from portbench.reference import model as ref_model
from portbench.reference import plain_ops
from portbench.reference import quantize as ref_quantize
from portbench.reference import train as ref_train

BETA1 = 0.5  # both optimizers' Adam beta1
# the logged losses held to the reference's: the autoencoder's and its
# terms, and the discriminator's (not g_loss, a mean of logits near 0)
LOSSES = ("aeloss", "discloss", "train/rec_loss", "train/quant_loss", "train/d_weight")
FIRST_LOSSES = ("discloss", "train/rec_loss", "train/quant_loss")  # compared at the first step


def _ref_modules(cfg: dict):
    loss = program.loss_config(cfg, ref_losses)
    return (ref_model.VQModel(program.vq_config(cfg, ref_autoencoder, ref_model, "float32", False)),
            ref_disc.NLayerDiscriminator(loss.disc_config), ref_lpips.LPIPS(), loss)


def _norms(tensors: dict) -> dict:
    return {n: float(t.detach().double().norm()) for n, t in tensors.items()}


def _worst_gap(prog: dict, ref: dict, keep) -> tuple:
    """(the worst tensor among `keep`, its gap, the median tensor's gap)."""
    floor = sorted(ref[n] for n in keep)[len(keep) // 2]
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], floor) for n in keep}
    worst = max(gaps, key=gaps.get)
    return worst, gaps[worst], sorted(gaps.values())[len(gaps) // 2]


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault=None):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.fault = fault  # tests only: wraps the program's step
        self.index = 0

    def batch(self, index: int) -> dict:
        return gen.train_batch(self.cfg, self.traffic, self.seed, index, self.device)

    def setup(self) -> None:
        with torch.device("meta"):
            model, disc, lpips, _ = _ref_modules(self.cfg)
        self.weights = (weights.vq_weights(model, self.seed, self.device, self.cfg["codebook_std"]),
                        weights.disc_weights(disc, self.seed, self.device),
                        weights.lpips_weights(lpips, self.seed, self.device))
        self.state, self.lpips, self.tcfg = program.train_state(self.cfg, *self.weights, self.device)
        self.names = [n for n, p in self.state.model.named_parameters() if p.requires_grad]
        params = dict(self.state.model.named_parameters())
        before = {n: params[n].detach().clone() for n in self.names}
        before.update({f"disc.{n}": p.detach().clone() for n, p in self.state.disc.named_parameters()})
        self.losses, self.latents, self.rows = [], [], []
        for i in range(self.traffic["check_steps"]):
            hook = (self.state.model.quant_conv.register_forward_hook(_keep(self.latents, self.rows))
                    if i == 0 else None)
            self.losses.append({k: float(v) for k, v in self.step().items() if k in LOSSES})
            if hook is not None:
                hook.remove()
            if i == 0:
                self.first_grad = _norms({**self._moments(self.state.opt_ae, self.state.model.named_parameters(), ""),
                                          **self._moments(self.state.opt_disc, self.state.disc.named_parameters(),
                                                          "disc.")})
        now = {**{n: params[n] for n in self.names},
               **{f"disc.{n}": p for n, p in self.state.disc.named_parameters()}}
        self.change = _norms({n: now[n].detach() - before[n] for n in before})

    @staticmethod
    def _moments(opt, named, prefix: str) -> dict:
        return {prefix + n: opt.state[p]["exp_avg"] / (1 - BETA1) if p in opt.state else torch.zeros_like(p)
                for n, p in named if p.requires_grad}

    def step(self) -> dict:
        step = program.train_step if self.fault is None else self.fault(program.train_step)
        logs = step(self.state, self.batch(self.index), self.lpips, self.tcfg)
        self.index += 1
        return logs

    def window(self, seconds: float) -> dict:
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        end, steps = t0, 0
        while end - t0 < seconds:
            self.step()
            sync()
            steps += 1
            end = time.perf_counter()
        return {"units": steps, "seconds": end - t0, "attempted": steps,
                "metrics": {"train_images_per_s": steps * self.traffic["batch"] / (end - t0)}}

    def trace_call(self):
        self.step()
        return 1

    def flops_per_unit(self) -> float:
        h, w = self.cfg["image_resolution"]

        def build():
            model, disc, lpips, loss = _ref_modules(self.cfg)
            return ref_train.make_state(model, disc, lpips, loss, self.cfg["learning_rate"])

        return work.train_flops(build, ref_train.model_losses, h, w, self.traffic["batch"])

    def check(self, control: bool = False) -> dict:
        """Free the program, run the reference's first steps and return the
        readings. With `control`, also the control's: the reference one
        precision below the configuration's (`plain_ops.low_precision`) in
        the program's place, read against the float32 reference."""
        del self.state, self.lpips
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = self._reference()
        out = _readings((self.latents, self.rows, self.losses, self.first_grad, self.change), ref)
        if control:
            with plain_ops.low_precision():
                low = self._reference()
            out.update({f"control_{k}": v for k, v in _readings(low, ref).items()})
        return out

    def _reference(self) -> tuple:
        """(first-step latents, first-step row gradient norms, losses, first
        gradient norms, change norms) of the reference's first
        `check_steps` steps from the benchmark's weights and batches."""
        plain_ops.set_f32()
        with torch.device("meta"):
            modules = _ref_modules(self.cfg)
        model, disc, lpips = (m.to_empty(device=self.device) for m in modules[:3])
        for m, sd in zip((model, disc, lpips), self.weights):
            m.load_state_dict(sd)
        state = ref_train.make_state(model, disc, lpips.requires_grad_(False), modules[3], self.cfg["learning_rate"])
        before = {**{n: p.detach().clone() for n, p in state.trainable.items()},
                  **{f"disc.{n}": p.detach().clone() for n, p in disc.named_parameters()}}
        losses, latents, rows = [], [], []
        for i in range(self.traffic["check_steps"]):
            hook = model.quant_conv.register_forward_hook(_keep(latents, rows)) if i == 0 else None
            losses.append(ref_train.step(state, self.batch(i), self.cfg["dataset"], tuple(self.cfg["depth_range"])))
            if hook is not None:
                hook.remove()
            if i == 0:
                first = _norms({**self._moments(state.opt_ae, state.trainable.items(), ""),
                                **self._moments(state.opt_disc, disc.named_parameters(), "disc.")})
        now = {**state.trainable, **{f"disc.{n}": p for n, p in disc.named_parameters()}}
        latents.append(model.codebook.detach())
        return latents, rows, losses, first, _norms({n: now[n].detach() - before[n] for n in before})


def _keep(into: list, rows: list):
    """A forward hook that keeps a module's first output (quant_conv's: the
    step's latents, [B, D, h, w]) and, once the step's backward reaches it,
    the norm of each row's gradient there."""
    def hook(module, args, out):
        if into:
            return
        into.append(out.detach().float())
        if out.requires_grad:
            out.register_hook(lambda g: rows.append(g.detach().double().flatten(1).norm(dim=1)))
    return hook


def _code_gap(latents: list, ref_latents: list) -> float:
    """Over every latent of the first step, the widest relative gap by which
    the squared distance of the codeword nearest the run's latent, from the
    reference's latent, lies above the reference's nearest (the codebook
    rides last in ref_latents); 1 where the run made no latents, or not
    one for every latent of the batch (a step that left rows out)."""
    if not latents:
        return 1.0
    book = ref_latents[-1].float()
    z, ref = (x.movedim(1, -1).reshape(-1, x.shape[1]) for x in (latents[0], ref_latents[0]))
    if z.shape != ref.shape:
        return 1.0
    dist = ref_quantize.codeword_distances(ref, book)
    pick = ref_quantize.codeword_distances(z, book).argmin(1)
    best = dist.min(1).values
    return float(((dist.gather(1, pick[:, None])[:, 0] - best) / best).max())


def _row_gap(rows: list, ref_rows: list) -> float:
    """Over every row of the first step's batch, the widest relative gap
    between the row's share of the gradient at the latents (its norm over
    the sum of every row's) in the run and in the reference; a row the run
    gave no gradient reads 1, and so does a run whose backward never
    reached the latents."""
    if not rows or not rows[0].any():
        return 1.0
    ref = ref_rows[0] / ref_rows[0].sum()
    run = torch.zeros_like(ref)
    n = min(len(ref), len(rows[0]))
    run[:n] = rows[0][:n]
    run = run / run.sum()
    return float(((run - ref).abs() / ref).max())


def _readings(run: tuple, ref: tuple) -> dict:
    """A run's (first-step latents, first-step row gradient norms, losses,
    first gradient norms, change norms) against the reference's. Compared:
    the first step's code gap (`_code_gap`), row gap (`_row_gap`) and losses
    (FIRST_LOSSES), the median tensor's first gradient gap and the worst
    tensor's change gap, leaving out tensors whose reference gradient is
    under a thousandth of the median tensor's. The worst tensor's gradient
    gap, the median tensor's change gap and every loss's gap at every step
    are kept beside them: they are not compared (PERF.md: the adaptive
    weight's rounding moves the later steps' losses, and the worst tensor's
    first gradient is a cancelling sum)."""
    (latents, rows, losses, first, change), (ref_latents, ref_rows, ref_losses, ref_first, ref_change) = run, ref
    median = sorted(ref_first.values())[len(ref_first) // 2]
    keep = [n for n in ref_first if ref_first[n] >= 1e-3 * median]
    grad_worst, grad_worst_gap, grad_gap = _worst_gap(first, ref_first, keep)
    change_worst, change_gap, change_median_gap = _worst_gap(change, ref_change, keep)
    gaps = {k: [abs(p.get(k, 0.0) - r[k]) / abs(r[k]) for p, r in zip(losses, ref_losses)] for k in LOSSES}
    return {"code_gap": _code_gap(latents, ref_latents), "row_gap": _row_gap(rows, ref_rows),
            "loss_gap": max(gaps[k][0] for k in FIRST_LOSSES), "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_worst_gap": grad_worst_gap, "change_median_gap": change_median_gap, "grad_worst": grad_worst,
            "change_worst": change_worst, **{f"gap:{k}": v for k, v in gaps.items()},
            "left_out": sorted(set(ref_first) - set(keep))}
