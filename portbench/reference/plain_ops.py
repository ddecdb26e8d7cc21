"""What the frozen reference calls in place of the port's hand kernels and
device helpers: plain PyTorch, in float32 with TF32 off.

- `zbuffer_min`, `nearest_codeword`, `grid_accumulate`, `flash_attention`:
  the plain versions of `sgam_neurips22_tpu_torch/ops/*.py` at commit
  e4e59b7 (copied), the grid accumulation through the deterministic
  `index_put_(accumulate=True)`;
- `resolve_device`, `f32_matmul`: `core/device.py`'s, with TF32 off;
- `low_precision`: the control of the benchmark's comparison, the
  reference computed one precision below the configuration's (float8
  e4m3 for bfloat16): each convolution's input and weight, and each
  attention product's operands, rounded to float8 e4m3 with a scale per
  tensor, as an fp8 deployment stores them; gradients unrounded.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

IMAX = 2**31 - 1
FP8_MAX = 448.0  # the largest finite float8 e4m3 value

_ROUNDING: contextvars.ContextVar = contextvars.ContextVar("rounding", default=None)


def set_f32() -> None:
    """float32 matmuls and convolutions: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def f32_matmul():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@contextlib.contextmanager
def low_precision(dtype=torch.float8_e4m3fn):
    """Inside the block, `rounded` rounds to `dtype` (per-tensor scale)."""
    token = _ROUNDING.set(dtype)
    try:
        yield
    finally:
        _ROUNDING.reset(token)


def rounded(x: torch.Tensor) -> torch.Tensor:
    """x as the low-precision block stores it (x itself outside one): scaled
    so that its largest magnitude is float8's largest, rounded, scaled back.
    Gradients pass through unrounded, as an fp8 forward with higher-precision
    gradients trains."""
    dtype = _ROUNDING.get()
    if dtype is None:
        return x
    with torch.no_grad():
        scale = FP8_MAX / x.abs().amax().float().clamp(min=1e-30)
        q = ((x * scale).to(dtype).to(x.dtype) / scale).to(x.dtype)
    return x + (q - x).detach() if x.requires_grad else q


def zbuffer_min(pix: torch.Tensor, key: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, P] pix, key -> [B, h*w] winner keys (the smallest), IMAX where empty."""
    ok = (pix >= 0) & (pix < h * w)
    out = torch.full((pix.shape[0], h * w), IMAX, dtype=torch.int32, device=pix.device)
    return out.scatter_reduce_(1, torch.where(ok, pix, 0).long(), torch.where(ok, key, IMAX), "amin")


def nearest_codeword(z_flat: torch.Tensor, codebook: torch.Tensor):
    """(argmin_k ||z - e_k||^2 [P] int32, its squared distance [P])."""
    z, e = z_flat.float(), codebook.float()
    with f32_matmul():
        d = (e * e).sum(dim=1)[None, :] - 2.0 * (z @ e.T)
    idx = torch.argmin(d, dim=1)
    return idx.to(torch.int32), d.gather(1, idx[:, None])[:, 0] + (z * z).sum(dim=1)


def grid_accumulate(grid: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """grid [V] += vals [N] at idx [N], in place, in an order that repeats."""
    return grid.index_put_((idx.long(),), vals, accumulate=True)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v over [B, S, C], in f32."""
    qf, kf, vf = (rounded(x.float()) for x in (q, k, v))
    with f32_matmul():
        logits = torch.bmm(qf * (1.0 / q.shape[-1] ** 0.5), kf.transpose(1, 2))
        return torch.bmm(rounded(torch.softmax(logits, dim=-1)), vf).to(q.dtype)

