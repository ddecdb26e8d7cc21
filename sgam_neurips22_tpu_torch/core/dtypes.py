"""The activation dtypes the model runs in, and the one widening rule that
every bf16 cast point shares."""
from __future__ import annotations

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or in its own dtype where that is wider: bf16 widened to
    f32, float64 (a CPU reference run's) kept."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
