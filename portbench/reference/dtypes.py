# Frozen copy of sgam_neurips22_tpu_torch/core/dtypes.py at commit e4e59b7, kept as the
# benchmark's plain reference: imports point into portbench.reference, and
# the hand kernels are replaced by the plain PyTorch versions of plain_ops.
"""The activation dtypes the model runs in, the one widening rule that
every bf16 cast point shares, and float -> int32 casts with XLA's
semantics."""
from __future__ import annotations

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
_F32_BELOW_2_31 = 2147483520.0  # the largest f32 below 2^31


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in its own dtype where that is wider: bf16 widened to
    f32, float64 (a CPU reference run's) kept."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """x cast to int32 as XLA converts a float: toward zero, NaN to 0, and
    +-inf or anything beyond int32's range saturated to INT32_MAX /
    INT32_MIN. torch's own cast gives INT32_MIN for all of those on the
    CPU and 0 for NaN on CUDA, so a NaN or infinite pixel coordinate would
    land elsewhere than in JAX (in bounds at 0 there)."""
    y = torch.nan_to_num(x, nan=0.0)
    i = y.clamp(float(INT32_MIN), _F32_BELOW_2_31).to(torch.int32)
    return torch.where(y >= 2.0**31, INT32_MAX, i)


def div_scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c correctly rounded, on the CPU and on CUDA alike: CUDA divides
    by a Python scalar through its reciprocal, which rounds differently
    from true division (and from the JAX package run op by op), so the
    divisor is a 0-dim tensor on x's device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)
