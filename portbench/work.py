"""The work the benchmark counts, from shapes alone: the card's peaks, the
algorithmic work and bytes of the hand attention kernels, and the model
FLOPs of a frame or a training step, counted with `FlopCounterMode` on the
meta device over the frozen reference (so a change to the program's own
model code moves no count).

Peaks: NVIDIA H100 SXM5 80GB HBM3 data sheet, dense, at its 700 W limit:
989 TFLOP/s in bf16 (the cells' compute dtype; the card's highest dense
rate for it) and 3.35 TB/s of HBM.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of its two bounds."""
    return max(flops / PEAK_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def flash_fwd(b: int, s: int, c: int) -> tuple:
    """(FLOPs, bytes) of attention forward over [B, S, C] f32: Q K^T and P V,
    q, k, v read once, out and the row logsumexp written once."""
    return 4.0 * b * s * s * c, F32 * (4 * b * s * c + b * s)


def flash_bwd(b: int, s: int, c: int) -> tuple:
    """(FLOPs, bytes) of the backward pair (dQ, then dK and dV) with no
    recompute: dP = dO V^T, dQ = dS K, dK = dS^T Q, dV = P^T dO; q, k, v, dout,
    lse and the row term read once, dq, dk, dv written once."""
    return 8.0 * b * s * s * c, F32 * (7 * b * s * c + 2 * b * s)


def forward_flops(build, h: int, w: int) -> float:
    """FLOPs of one frame's forward (encode, codeword search, decode) of the
    model `build()` makes (on the meta device)."""
    with torch.device("meta"):
        model = build()
        x = torch.empty((1, h, w, 4))
        mask = torch.empty((1, h, w, 1), dtype=torch.bool)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x, extrapolation_mask=mask, flash=False)
    return float(counter.get_total_flops())


def train_flops(build, loss_inputs, h: int, w: int, batch: int) -> float:
    """FLOPs of one training step at `batch` (both losses' forward and
    backward, no recompute): `build()` makes the reference's training state
    and `loss_inputs(state, x, x_dst, mask)` runs its losses and gradients."""
    with torch.device("meta"):
        state = build()
        x, x_dst = torch.empty((batch, h, w, 4)), torch.empty((batch, h, w, 4))
        mask = torch.empty((batch, h, w, 1), dtype=torch.bool)
    with FlopCounterMode(display=False) as counter:
        loss_inputs(state, x, x_dst, mask)
    return float(counter.get_total_flops())
