"""Deterministic scatter-add into the TSDF grid: grid[idx[i]] += vals[i],
each key's samples added one by one in their order.

`grid_accumulate` calls the custom op `torch.ops.sgam.grid_accumulate`
(`ops/library.py`; it mutates `grid` and returns nothing, since an op may
not return an alias of its input), whose CUDA implementation
`grid_accumulate_cuda` launches the CUDA kernel `csrc/grid_accumulate.cu`
after a stable sort of the keys (the kernel walks each key's run and
writes the key once), and whose CPU implementation is
`grid_accumulate_plain`, the sequential `index_add_`; nothing else selects
the plain version. Both form the sum the JAX package's scatter-add forms
on the CPU, so the card's grid is the CPU's bit for bit, and the same
frames give the same grid run after run (index_add_'s float atomics on
the card do not).
"""
from __future__ import annotations

import ctypes

import torch

from sgam_neurips22_tpu_torch.ops import cuda_build

_SIGNATURES = {
    "grid_accumulate_launch": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p],
}


def grid_accumulate_plain(grid: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: index_add_, sequential on the CPU."""
    return grid.index_add_(0, idx, vals)


def _check(grid: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    if grid.dim() != 1 or idx.dim() != 1 or vals.shape != idx.shape:
        raise ValueError(f"grid {tuple(grid.shape)}, idx {tuple(idx.shape)}, vals {tuple(vals.shape)}: "
                         "want [V], [N], [N]")


def grid_accumulate(grid: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """grid [V] f32 += vals [N] f32 at idx [N] int32, in place; returns grid."""
    _check(grid, idx, vals)
    if grid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grid_accumulate: no kernel for device {grid.device}")
    torch.ops.sgam.grid_accumulate(grid, idx, vals)
    return grid


def grid_accumulate_cuda(grid: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """The op's CUDA implementation: a stable sort and one launch of the
    kernel, counted in `grid_accumulate.launches`."""
    _check(grid, idx, vals)
    if grid.device.type != "cuda" or idx.device != grid.device or vals.device != grid.device:
        raise ValueError(f"grid_accumulate: grid on {grid.device}, idx on {idx.device}, vals on {vals.device}")
    if grid.dtype != torch.float32 or vals.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("grid_accumulate takes a float32 grid and values and int32 indices")
    if not grid.is_contiguous():
        raise ValueError("grid_accumulate takes a contiguous grid")
    keys, order = torch.sort(idx, stable=True)
    ordered = vals[order]
    lib = cuda_build.library("grid_accumulate", _SIGNATURES)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.grid_accumulate_launch(keys.data_ptr(), ordered.data_ptr(), grid.data_ptr(), keys.numel(), stream)
    cuda_build.check(rc, "grid_accumulate")
    grid_accumulate.launches += 1


grid_accumulate.launches = 0
