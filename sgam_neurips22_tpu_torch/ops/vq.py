"""Nearest-codeword search: argmin_k ||z - e_k||^2 with first-occurrence ties.

`nearest_codeword` launches the CUDA kernel `csrc/nearest_codeword.cu` for
a CUDA tensor and runs `nearest_codeword_plain` for a CPU tensor; nothing
else selects the plain version. It replaces the TPU kernel
`sgam_neurips22_tpu/ops/vq_pallas.py::nearest_codeword` (see the .cu for its
design and bound). Both versions rank codewords by ||e||^2 - 2 z.e, as the
TPU kernel does, and add ||z||^2 to the winning distance only.
"""
from __future__ import annotations

import ctypes

import torch

from sgam_neurips22_tpu_torch.ops import cuda_build

_SIGNATURES = {
    "nearest_codeword_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def nearest_codeword_plain(z_flat: torch.Tensor, codebook: torch.Tensor):
    """Plain PyTorch version, f32 matmul (the caller keeps TF32 off)."""
    z = z_flat.float()
    e = codebook.float()
    d = (e * e).sum(dim=1)[None, :] - 2.0 * (z @ e.T)
    idx = torch.argmin(d, dim=1)  # first occurrence on ties
    dist = d.gather(1, idx[:, None])[:, 0] + (z * z).sum(dim=1)
    return idx.to(torch.int32), dist


def nearest_codeword(z_flat: torch.Tensor, codebook: torch.Tensor):
    """argmin_k ||z - e_k||^2 for each row of z.

    Args:
      z_flat: [P, D] f32 latents; codebook: [K, D] f32. On the card D is
        256, the embed_dim of every configuration.
    Returns:
      (indices [P] int32, squared distances [P] f32, ||z||^2 included).
    """
    if z_flat.dim() != 2 or codebook.dim() != 2 or z_flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"z {tuple(z_flat.shape)} and codebook {tuple(codebook.shape)} must be [P, D] and [K, D]")
    if codebook.shape[0] < 1:
        raise ValueError("empty codebook")
    if z_flat.device.type == "cpu":
        return nearest_codeword_plain(z_flat, codebook)
    if z_flat.device.type != "cuda" or codebook.device != z_flat.device:
        raise ValueError(f"nearest_codeword: z on {z_flat.device}, codebook on {codebook.device}")
    if z_flat.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError("nearest_codeword takes float32 z and codebook")
    if not (z_flat.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("nearest_codeword takes contiguous z and codebook")
    if z_flat.data_ptr() % 16 or codebook.data_ptr() % 16:
        raise ValueError("nearest_codeword takes 16-byte aligned z and codebook")
    (p, d), k = z_flat.shape, codebook.shape[0]
    if d != 256:
        raise ValueError(f"nearest_codeword takes depth 256 (every configuration's embed_dim), not {d}")
    dev = z_flat.device
    idx = torch.empty(p, dtype=torch.int32, device=dev)
    dist = torch.empty(p, dtype=torch.float32, device=dev)
    best = torch.empty(p, dtype=torch.int64, device=dev)
    lib = cuda_build.library("nearest_codeword", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nearest_codeword_launch(
            z_flat.data_ptr(), codebook.data_ptr(), best.data_ptr(), idx.data_ptr(), dist.data_ptr(),
            p, k, d, stream,
        )
    cuda_build.check(rc, "nearest_codeword")
    nearest_codeword.launches += 1
    return idx, dist


nearest_codeword.launches = 0
