"""Nearest-codeword search: argmin_k ||z - e_k||^2 with first-occurrence ties.

`nearest_codeword` calls the custom op `torch.ops.sgam.nearest_codeword`
(`ops/library.py`), whose CUDA implementation `nearest_codeword_cuda`
launches the CUDA kernel `csrc/nearest_codeword.cu` and whose CPU
implementation is `nearest_codeword_plain`; nothing else selects the plain
version. It replaces the TPU kernel
`sgam_neurips22_tpu/ops/vq_pallas.py::nearest_codeword` (see the .cu for its
design and bound). Both versions rank codewords by ||e||^2 - 2 z.e, as the
TPU kernel does, and add ||z||^2 to the winning distance only.

The kernel's 3xTF32 product is f32-accurate in every matmul precision mode
(`core.device.set_matmul_precision`): JAX pins this search at
`Precision.HIGHEST` (its `codeword_distances`, and the Pallas kernel's
6-pass bf16 product), so TF32 mode does not reach it.
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


def _check(z_flat: torch.Tensor, codebook: torch.Tensor) -> None:
    if z_flat.dim() != 2 or codebook.dim() != 2 or z_flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"z {tuple(z_flat.shape)} and codebook {tuple(codebook.shape)} must be [P, D] and [K, D]")
    if codebook.shape[0] < 1:
        raise ValueError("empty codebook")


def nearest_codeword(z_flat: torch.Tensor, codebook: torch.Tensor):
    """argmin_k ||z - e_k||^2 for each row of z.

    Args:
      z_flat: [P, D] f32 latents; codebook: [K, D] f32. On the card D is
        256, the embed_dim of every configuration.
    Returns:
      (indices [P] int32, squared distances [P] f32, ||z||^2 included).
    """
    _check(z_flat, codebook)
    if z_flat.device.type not in ("cpu", "cuda") or codebook.device != z_flat.device:
        raise ValueError(f"nearest_codeword: z on {z_flat.device}, codebook on {codebook.device}")
    return torch.ops.sgam.nearest_codeword(z_flat, codebook)


def nearest_codeword_cuda(z_flat: torch.Tensor, codebook: torch.Tensor):
    """The op's CUDA implementation: one launch of the kernel, counted in
    `nearest_codeword.launches`."""
    _check(z_flat, codebook)
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


def near_ties_ok(z: torch.Tensor, cb: torch.Tensor, idx: torch.Tensor, ref_idx: torch.Tensor,
                 with_z2: bool = False) -> tuple[int, bool]:
    """(rows whose indices differ, whether every one is an f32 near-tie):
    the two codewords' exact (f64) scores e2 - 2 z.e within 1e-6 of the
    scale of their f32 sums. `with_z2` adds ||z||^2 to that scale, for a
    search whose f32 distances carry it (the parity oracle's)."""
    rows = torch.nonzero(idx != ref_idx).flatten()
    if len(rows) == 0:
        return 0, True
    z64 = z[rows].double()
    a, b = (cb[i[rows].long()].double() for i in (idx, ref_idx))
    score = [(e * e).sum(1) - 2 * (z64 * e).sum(1) for e in (a, b)]
    scale = torch.maximum(*((e * e).sum(1) + 2 * (z64 * e).abs().sum(1) for e in (a, b)))
    if with_z2:
        scale = scale + (z64 * z64).sum(1)
    return len(rows), bool(((score[0] - score[1]).abs() <= 1e-6 * scale).all())


def distance_gate_share(z: torch.Tensor, cb: torch.Tensor, idx: torch.Tensor, dist: torch.Tensor) -> float:
    """The largest error of a winning distance against the float64
    ||z - e_idx||^2, as a share of its gate 1e-6 (||z||^2 + ||e_idx||^2 +
    2 sum |z e_idx|): the scale of the f32 sums that make the distance."""
    z64, e64 = z.double(), cb[idx.long()].double()
    ref = ((z64 - e64) ** 2).sum(1)
    scale = (z64 * z64).sum(1) + (e64 * e64).sum(1) + 2 * (z64 * e64).abs().sum(1)
    return float(((dist.double() - ref).abs() / (1e-6 * scale)).max())
