"""Z-buffer merge of the forward splat: per-image scatter-min of packed keys.

`zbuffer_min` launches the CUDA kernel `csrc/zbuffer_min.cu` for a CUDA
tensor and runs `zbuffer_min_plain` for a CPU tensor; nothing else selects
the plain version. It replaces the TPU kernel
`sgam_neurips22_tpu/ops/splat_pallas.py::zbuffer_min` (see the .cu for its
design and bound).
"""
from __future__ import annotations

import ctypes

import torch

from sgam_neurips22_tpu_torch.ops import cuda_build

IMAX = 2**31 - 1
_SIGNATURES = {
    "zbuffer_min_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def zbuffer_min_plain(pix: torch.Tensor, key: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch version: [B, P] pix, key -> [B, h*w] winner keys."""
    ok = (pix >= 0) & (pix < h * w)  # out-of-range ids drop, like XLA's mode="drop"
    out = torch.full((pix.shape[0], h * w), IMAX, dtype=torch.int32, device=pix.device)
    return out.scatter_reduce_(
        1, torch.where(ok, pix, 0).long(), torch.where(ok, key, IMAX), "amin"
    )


def zbuffer_min(pix: torch.Tensor, key: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Per-image scatter-min of int32 keys over linear pixel ids.

    Args:
      pix: [B, P] int32 linear pixel ids in [0, h*w); invalid points carry
        pixel 0 and key INT32_MAX.
      key: [B, P] int32 packed keys; the smallest wins.
    Returns:
      [B, h*w] int32 winner keys, INT32_MAX where no point landed;
      bit-identical to `full(INT32_MAX).at[pix].min(key)` per image.
    """
    if pix.shape != key.shape or pix.dim() != 2:
        raise ValueError(f"pix {tuple(pix.shape)} and key {tuple(key.shape)} must be one [B, P] shape")
    if pix.dtype != torch.int32 or key.dtype != torch.int32:
        raise TypeError("zbuffer_min takes int32 pix and key")
    if pix.device.type == "cpu":
        return zbuffer_min_plain(pix, key, h, w)
    if pix.device.type != "cuda" or key.device != pix.device:
        raise ValueError(f"zbuffer_min: pix on {pix.device}, key on {key.device}")
    if not (pix.is_contiguous() and key.is_contiguous()):
        raise ValueError("zbuffer_min takes contiguous pix and key")
    b, p = pix.shape
    out = torch.full((b, h * w), IMAX, dtype=torch.int32, device=pix.device)
    lib = cuda_build.library("zbuffer_min", _SIGNATURES)
    with torch.cuda.device(pix.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.zbuffer_min_launch(
            pix.data_ptr(), key.data_ptr(), out.data_ptr(), b, p, h * w, stream
        )
    cuda_build.check(rc, "zbuffer_min")
    zbuffer_min.launches += 1
    return out


zbuffer_min.launches = 0
