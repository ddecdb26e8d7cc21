"""Single-head flash attention, forward: softmax(q k^T / sqrt(C)) v and the
per-row logsumexp, for [B, S, C] float32 tensors (the JAX package's layout).

`flash_attention_fwd` launches the CUDA kernel `csrc/flash_attention_fwd.cu`
for CUDA tensors and runs `flash_attention_plain` for CPU tensors; nothing
else selects the plain version. It replaces the TPU kernel
`sgam_neurips22_tpu/ops/attention_pallas.py::_flash_fwd_impl` (see the .cu for
its design and bound). Both versions scale q by 1/sqrt(C) before the dot, as
the TPU kernel does. The logsumexp is what the backward pass of training
recomputes the probabilities from.
"""
from __future__ import annotations

import ctypes

import torch

from sgam_neurips22_tpu_torch.ops import cuda_build

KERNEL_CHANNELS = (64, 128, 256, 512)  # the widths the kernel is instantiated for
_SIGNATURES = {
    "flash_attention_fwd_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain PyTorch version: full [B, S, S] logits, softmax, logsumexp."""
    logits = torch.bmm(q * (1.0 / q.shape[-1] ** 0.5), k.transpose(1, 2))
    return torch.bmm(torch.softmax(logits, dim=-1), v), torch.logsumexp(logits, dim=-1)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Attention forward over single-head tensors.

    Args:
      q, k, v: [B, S, C] float32, one device.
    Returns:
      (out [B, S, C], lse [B, S]) with lse the row logsumexp of q k^T / sqrt(C).
    """
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} must be one [B, S, C] shape")
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError("flash_attention_fwd takes float32 q, k and v")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention_fwd: q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device {q.device}")
    b, s, c = q.shape
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"flash_attention_fwd: the kernel takes C in {KERNEL_CHANNELS}, got {c}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in (q, k, v)):
        raise ValueError("flash_attention_fwd takes contiguous, 16-byte aligned q, k and v")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(C)) v for single-head [B, S, C] tensors."""
    return flash_attention_fwd(q, k, v)[0]
