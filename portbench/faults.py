"""Faults planted in the timed path, each of which a cell's check has to
catch (`portbench/tests/` plants them on the CPU; `control.py` reads the
training step's on the card):

- `altered_frame`: an answer altered where it is produced: scene 0's first
  generated frame of a request comes out with its RGB negated;
- `half_batch`: a training step that leaves out half of its batch and
  takes the mean over the rest;
- `half_batch_loss`: the same inside the loss: the step encodes and
  decodes every row, and its autoencoder loss is the mean over the first
  half of the rows;
- `unchanged`: a training step that returns its state unchanged.
"""
from __future__ import annotations

import torch

from portbench import program


def altered_frame(rgb: torch.Tensor, depth: torch.Tensor) -> None:
    """In place on a request's outputs (rgb [S, G, H, W, 3]): grid index 1
    is generated on every trajectory the cells run."""
    with torch.inference_mode():  # the unroll's outputs are inference tensors
        rgb[0, 1].neg_()


def half_batch(step):
    def faulty(state, batch, lpips, tcfg):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, lpips, tcfg)

    return faulty


def half_batch_loss(step):
    def first_half(loss):
        def faulty(x_dst, h_pre, *rest):
            n = x_dst.shape[0] // 2
            return loss(x_dst[:n], h_pre[:n], *rest)

        return faulty

    def faulty(state, batch, lpips, tcfg):
        with program.generator_loss_wrapped(first_half):
            return step(state, batch, lpips, tcfg)

    return faulty


def unchanged(step):
    def faulty(state, batch, lpips, tcfg):
        zero = torch.zeros((), device=batch["dst_img"].device)
        return {"aeloss": zero, "discloss": zero}

    return faulty


FAULTS = {"altered_frame": altered_frame, "half_batch": half_batch, "half_batch_loss": half_batch_loss,
          "unchanged": unchanged}
