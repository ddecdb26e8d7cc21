"""Deterministic scatter-add into the TSDF grid: grid[idx[i]] += vals[i],
each key's samples added one by one in their order.

`grid_accumulate` calls the custom op `torch.ops.sgam.grid_accumulate`
(`ops/library.py`; it mutates `grid` and returns nothing, since an op may
not return an alias of its input), whose CUDA implementation
`grid_accumulate_cuda` makes one call into `csrc/grid_accumulate.cu`: hand
kernels that drop the zero addends (under the -0.0 rule the source states),
sort the rest stably by key with a radix sort over the bits the grid's size
needs, the f32 value riding beside its key, and walk each key's run onto
the grid, writing the key once. Its CPU implementation is
`grid_accumulate_plain`, the sequential `index_add_`; nothing else selects
the plain version. Both form the sum the JAX package's scatter-add forms
on the CPU, so the card's grid is the CPU's bit for bit, and the same
frames give the same grid run after run (index_add_'s float atomics on
the card do not). Keys outside [0, V) are dropped on the card, as JAX's
scatter drops them; index_add_ raises for them.
"""
from __future__ import annotations

import ctypes

import torch

from sgam_neurips22_tpu_torch.ops import cuda_build

_SIGNATURES = {
    "grid_accumulate_launch": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                                                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "grid_accumulate_sorted_launch": [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p],
}
# the radix sort's widest digit (8-10 bits): 9 gives CLEVR's 25 key bits 3
# passes and the 28 of google_earth and the 8-scene map 4 of 7 bits, within
# 1% of the fastest of the three at each map caller on the card (PERF.md)
MAX_DIGIT_BITS = 9
# csrc/grid_accumulate.cu's chunk (a scatter block's samples) and scratch:
# counters, histograms, the [digit][chunk] counts and offsets, two buffers
# of (key, value) pairs
_CHUNK = 2 * 512 * 4
_COUNTERS, _MAX_PASSES, _MAX_BINS = 8, 4, 1024


def grid_accumulate_plain(grid: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: index_add_, sequential on the CPU."""
    return grid.index_add_(0, idx, vals)


def digit_plan(voxels: int, max_bits: int = MAX_DIGIT_BITS) -> list[tuple[int, int]]:
    """[(shift, bits)] of the radix sort's passes for keys below `voxels`:
    the bits V - 1 needs (at least 1) in ceil(bits / max_bits) digits, the
    first bits % passes of them one bit wider (the kernel's own plan)."""
    key_bits = max(1, min(31, (int(voxels) - 1).bit_length()))
    passes = -(-key_bits // max_bits)
    base, extra = divmod(key_bits, passes)
    plan, shift = [], 0
    for i in range(passes):
        bits = base + (i < extra)
        plan.append((shift, bits))
        shift += bits
    return plan


def _chunks(n: int) -> int:
    """G, the chunks the kernels cut n samples into in every pass."""
    return -(-n // _CHUNK)


def _scratch_words(n: int) -> int:
    return _COUNTERS + _MAX_PASSES * _MAX_BINS + 2 * _MAX_BINS * _chunks(n) + 4 * n


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


def _check_cuda(grid: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    _check(grid, idx, vals)
    if grid.device.type != "cuda" or idx.device != grid.device or vals.device != grid.device:
        raise ValueError(f"grid_accumulate: grid on {grid.device}, idx on {idx.device}, vals on {vals.device}")
    if grid.dtype != torch.float32 or vals.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("grid_accumulate takes a float32 grid and values and int32 indices")
    if not (grid.is_contiguous() and idx.is_contiguous() and vals.is_contiguous()):
        raise ValueError("grid_accumulate takes a contiguous grid, idx and vals")
    if idx.numel() >= 1 << 30 or grid.numel() > 1 << 31:
        raise ValueError(f"grid_accumulate: {idx.numel()} samples into {grid.numel()} voxels: "
                         "want fewer than 2^30 samples and at most 2^31 voxels")


def launch(grid: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, max_bits: int = MAX_DIGIT_BITS) -> None:
    """The one C call of the CUDA route, with the sort's widest digit as an
    argument; uncounted (grid_accumulate_cuda counts)."""
    _check_cuda(grid, idx, vals)
    n = idx.numel()
    scratch = torch.empty(_scratch_words(n), dtype=torch.int32, device=grid.device)
    lib = cuda_build.library("grid_accumulate", _SIGNATURES)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.grid_accumulate_launch(idx.data_ptr(), vals.data_ptr(), grid.data_ptr(), n, grid.numel(),
                                        scratch.data_ptr(), scratch.numel() * 4, max_bits, stream)
    cuda_build.check(rc, "grid_accumulate")


def grid_accumulate_cuda(grid: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """The op's CUDA implementation: one call of the kernels, counted once
    in `grid_accumulate.launches`."""
    launch(grid, idx, vals)
    grid_accumulate.launches += 1


grid_accumulate.launches = 0
