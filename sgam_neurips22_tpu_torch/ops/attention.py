"""Single-head flash attention: softmax(q k^T / sqrt(C)) v over [B, S, C]
tensors (the JAX package's layout), forward and backward. The kernels take
float32; `flash_attention` also takes bf16 and casts around them.

`flash_attention` goes through the `FlashAttention` autograd function on
every device, as the JAX `flash_attention` carries its custom VJP: the
forward saves (q, k, v, out, lse) and the backward recomputes the
probabilities from the row logsumexp.

- `flash_attention_fwd` launches `csrc/flash_attention_fwd.cu` for CUDA
  tensors (replaces `sgam_neurips22_tpu/ops/attention_pallas.py::
  _flash_fwd_impl`; 3xTF32 on the tensor cores, with a tile of 64 query
  rows, 32 at C = 512, or 16 where the larger tile leaves SMs idle:
  `flash_attention_fwd_block_rows`) and runs `flash_attention_plain` for
  CPU tensors. Both scale q by 1/sqrt(C) before the dot, as the TPU kernel
  does.
- `flash_attention_bwd` launches two kernels for CUDA tensors,
  `flash_attention_dq` (`csrc/flash_attention_dq.cu`, replacing
  `_dq_kernel`) and `flash_attention_dkv` (`csrc/flash_attention_dkv.cu`,
  replacing `_dkv_kernel`), both 3xTF32 on the tensor cores, and runs
  `flash_attention_bwd_plain` for CPU tensors. Both apply the scale after
  the dot, as the TPU backward kernels do.
  D = rowsum(dO * O) is plain torch, as it is plain XLA in JAX.

Nothing else selects a plain version: a CUDA tensor launches a kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from sgam_neurips22_tpu_torch.core.dtypes import at_least_f32
from sgam_neurips22_tpu_torch.ops import cuda_build

KERNEL_CHANNELS = (64, 128, 256, 512)  # the widths the kernels are instantiated for
_SIGNATURES = {
    "flash_attention_fwd_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "flash_attention_fwd_block_rows": [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)],
}
_DQ_SIGNATURES = {
    "flash_attention_dq_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}
_DKV_SIGNATURES = {
    "flash_attention_dkv_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def _check(name: str, *xs: torch.Tensor) -> None:
    """Same [B, S, C] float32 shape on one device (lse-like [B, S] after)."""
    q = xs[0]
    if q.dim() != 3 or any(x.shape != q.shape for x in xs):
        raise ValueError(f"{name}: {[tuple(x.shape) for x in xs]} must be one [B, S, C] shape")
    if any(x.dtype != torch.float32 for x in xs):
        raise TypeError(f"{name} takes float32 tensors")
    if any(x.device != q.device for x in xs):
        raise ValueError(f"{name}: tensors on {[str(x.device) for x in xs]}")


def _kernel_inputs(name: str, xs) -> None:
    """What the CUDA kernels take: C in KERNEL_CHANNELS, contiguous, 16-byte aligned."""
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    c = xs[0].shape[-1]
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"{name}: the kernel takes C in {KERNEL_CHANNELS}, got {c}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in xs):
        raise ValueError(f"{name} takes contiguous, 16-byte aligned tensors")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch version: full [B, S, S] logits, softmax, logsumexp."""
    logits = torch.bmm(q * (1.0 / q.shape[-1] ** 0.5), k.transpose(1, 2))
    return torch.bmm(torch.softmax(logits, dim=-1), v), torch.logsumexp(logits, dim=-1)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Attention forward over single-head tensors; on CUDA tensors the
    kernel `flash_fwd_kernel` (3xTF32 on the tensor cores, within f32
    rounding of flash_attention_plain, not bit-equal to it).

    Args:
      q, k, v: [B, S, C] float32, one device.
    Returns:
      (out [B, S, C], lse [B, S]) with lse the row logsumexp of q k^T / sqrt(C).
    """
    _check("flash_attention_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    _kernel_inputs("flash_attention_fwd", (q, k, v))
    b, s, c = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, s), dtype=torch.float32, device=q.device)
    lib = cuda_build.library("flash_attention_fwd", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, c, stream
        )
    cuda_build.check(rc, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_fwd_block_rows(b: int, s: int, c: int, device) -> int:
    """The query rows a block of `flash_fwd_kernel` owns for [b, s, c]
    inputs on CUDA `device`: the kernel's own tile rule, asked of the
    library (nothing is launched)."""
    lib = cuda_build.library("flash_attention_fwd", _SIGNATURES)
    bq = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.flash_attention_fwd_block_rows(b, s, c, ctypes.byref(bq))
    cuda_build.check(rc, "flash_attention_fwd_block_rows")
    return bq.value


def _probs_and_ds(q, k, v, dout, lse, dd):
    """[B, S, S] P = exp(scale * (q k^T) - lse) and dS = P * (dO v^T - D)."""
    scale = 1.0 / q.shape[-1] ** 0.5
    p = torch.exp(scale * torch.bmm(q, k.transpose(1, 2)) - lse[..., None])
    return p, p * (torch.bmm(dout, v.transpose(1, 2)) - dd[..., None])


def flash_attention_dq_plain(q, k, v, dout, lse, dd):
    """Plain PyTorch version of flash_attention_dq: scale * dS k."""
    return (1.0 / q.shape[-1] ** 0.5) * torch.bmm(_probs_and_ds(q, k, v, dout, lse, dd)[1], k)


def flash_attention_dkv_plain(q, k, v, dout, lse, dd):
    """Plain PyTorch version of flash_attention_dkv: (scale * dS^T q, P^T dO)."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, dd)
    return (1.0 / q.shape[-1] ** 0.5) * torch.bmm(ds.transpose(1, 2), q), torch.bmm(p.transpose(1, 2), dout)


def flash_attention_bwd_plain(q, k, v, out, lse, dout):
    """Plain PyTorch version of the backward, with [B, S, S] tensors:
    logits = scale * (q k^T), P = exp(logits - lse), D = rowsum(dO * O),
    dS = P * (dO v^T - D), dq = scale * dS k, dk = scale * dS^T q,
    dv = P^T dO. It forms P and dS once for the three."""
    scale = 1.0 / q.shape[-1] ** 0.5
    p, ds = _probs_and_ds(q, k, v, dout, lse, (dout * out).sum(dim=-1))
    dq = scale * torch.bmm(ds, k)
    return dq, scale * torch.bmm(ds.transpose(1, 2), q), torch.bmm(p.transpose(1, 2), dout)


def _rows(name: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    for r in rows:
        if r.shape != q.shape[:2] or r.dtype != torch.float32 or r.device != q.device:
            raise ValueError(f"{name}: row tensor {tuple(r.shape)} {r.dtype} on {r.device} "
                             f"is not float32 {tuple(q.shape[:2])} on {q.device}")


def flash_attention_dq(q, k, v, dout, lse, dd):
    """dq of attention from the kernel `flash_dq_kernel` (CUDA tensors only;
    3xTF32 on the tensor cores, within f32 rounding of
    flash_attention_dq_plain, not bit-equal to it). dd is
    rowsum(dout * out), [B, S] like lse."""
    _check("flash_attention_dq", q, k, v, dout)
    _rows("flash_attention_dq", q, lse, dd)
    _kernel_inputs("flash_attention_dq", (q, k, v, dout, lse, dd))
    b, s, c = q.shape
    dq = torch.empty_like(q)
    lib = cuda_build.library("flash_attention_dq", _DQ_SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dd.data_ptr(),
            dq.data_ptr(), b, s, c, stream,
        )
    cuda_build.check(rc, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, dout, lse, dd):
    """(dk, dv) of attention from the kernel `flash_dkv_kernel` (CUDA
    tensors only; 3xTF32 like flash_attention_dq); arguments as
    flash_attention_dq."""
    _check("flash_attention_dkv", q, k, v, dout)
    _rows("flash_attention_dkv", q, lse, dd)
    _kernel_inputs("flash_attention_dkv", (q, k, v, dout, lse, dd))
    b, s, c = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = cuda_build.library("flash_attention_dkv", _DKV_SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), dd.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, s, c, stream,
        )
    cuda_build.check(rc, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout):
    """Attention backward: (dq, dk, dv) for the upstream gradient dout of
    out = flash_attention(q, k, v), from the forward's (out, lse)."""
    _check("flash_attention_bwd", q, k, v, out, dout)
    _rows("flash_attention_bwd", q, lse)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout)
    dd = (dout * out).sum(dim=-1)
    return (flash_attention_dq(q, k, v, dout, lse, dd), *flash_attention_dkv(q, k, v, dout, lse, dd))


class FlashAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(C)) v with the flash-attention backward: the JAX
    `_flash_attention` custom VJP (residuals q, k, v, out, lse). As the JAX
    kernels do, it computes in f32 whatever the inputs' dtype: bf16 inputs
    go in widened, `out` comes back in q's dtype and is the residual that
    D = rowsum(dO * O) reads, and each gradient is in its input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(at_least_f32(q), at_least_f32(k), at_least_f32(v))
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_bwd(*(at_least_f32(x) for x in (q, k, v, out)), lse, at_least_f32(dout).contiguous())
        return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v for single-head [B, S, C] tensors of one
    floating dtype (f32 inside the kernels), differentiable through
    `FlashAttention`."""
    return FlashAttention.apply(q, k, v)
