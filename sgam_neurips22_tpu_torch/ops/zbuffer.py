"""Z-buffer merge of the forward splat: per-image scatter-min of packed keys.

`zbuffer_min` launches the CUDA kernels of `csrc/zbuffer_min.cu` for a CUDA
tensor and runs `zbuffer_min_plain` for a CPU tensor; nothing else selects
the plain version. It replaces the TPU kernel
`sgam_neurips22_tpu/ops/splat_pallas.py::zbuffer_min` (see the .cu for its
design and bound). `zbuffer_plan` picks the kernel's route from the shape
alone: the shared-memory row window ("tile") where each block has points
enough to amortise its window, the L2 route ("l2") elsewhere.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sgam_neurips22_tpu_torch.ops import cuda_build

IMAX = 2**31 - 1
ROUTES = ("l2", "tile")  # by the C entry point's route code
TILE_BYTES = 200 * 1024  # a tile block's window of target rows in shared memory
TILE_BLOCKS = 128  # tile blocks over the whole batch: one a streaming multiprocessor
L2_BLOCKS = 528  # l2 blocks over the whole batch: four a streaming multiprocessor
_SIGNATURES = {
    "zbuffer_min_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}


class ZbufferPlan(NamedTuple):
    route: str  # one of ROUTES
    parts: int  # blocks an image
    segments: int  # tile: equal point ranges (sources) whose parts a block takes
    tile_rows: int  # tile: rows of the window


def route_plan(route: str, b: int, p: int, h: int, w: int) -> ZbufferPlan:
    """The launch shape of `route` for pix, key [b, p] over an h x w image.

    tile: TILE_BLOCKS blocks over the batch (at least one an image), each
    with a window of as many rows as TILE_BYTES holds; a point range of
    whole h*w images is taken as that many sources, each block one part of
    each. l2: L2_BLOCKS blocks over the batch."""
    n, b = h * w, max(b, 1)
    if route == "tile":
        segments = p // n if p >= n and p % n == 0 else 1
        return ZbufferPlan("tile", max(1, TILE_BLOCKS // b), segments, min(h, TILE_BYTES // (4 * w)))
    if route != "l2":
        raise ValueError(f"unknown z-buffer route {route!r}")
    return ZbufferPlan("l2", max(1, -(-L2_BLOCKS // b)), 1, 0)


def zbuffer_plan(b: int, p: int, h: int, w: int) -> ZbufferPlan:
    """The route and launch shape for pix, key [b, p] over an h x w image:
    the tile route where a block's points number at least a quarter of its
    window's pixels, so that filling and scanning the window costs less
    than the L2 atomics it saves (measured, PERF.md: the 8-scene unroll,
    the training step, the 8-scene pool splat; a batch of one splat,
    google_earth, a 1024^2 image and the batch-1 map's pool splats take
    the l2 route)."""
    tile = route_plan("tile", b, p, h, w)
    if tile.tile_rows >= 1 and 4 * (p // tile.parts) >= tile.tile_rows * w:
        return tile
    return route_plan("l2", b, p, h, w)


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
        pixel 0 and key INT32_MAX; ids outside [0, h*w) are dropped.
      key: [B, P] int32 packed keys; the smallest wins.
    Returns:
      [B, h*w] int32 winner keys, INT32_MAX where no point landed;
      bit-identical to `full(INT32_MAX).at[pix].min(key, mode="drop")` per
      image. On the card both routes merge into an output filled with
      INT32_MAX first.
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
    out = _launch(pix, key, h, w, zbuffer_plan(*pix.shape, h, w))
    zbuffer_min.launches += 1
    return out


def _launch(pix: torch.Tensor, key: torch.Tensor, h: int, w: int, plan: ZbufferPlan) -> torch.Tensor:
    """One launch of the kernels on `plan`'s route, for CUDA tensors that
    zbuffer_min has checked (or chip_smoke's timing of both routes at one
    shape); counts nothing."""
    b, p = pix.shape
    out = torch.full((b, h * w), IMAX, dtype=torch.int32, device=pix.device)
    lib = cuda_build.library("zbuffer_min", _SIGNATURES)
    with torch.cuda.device(pix.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.zbuffer_min_launch(
            pix.data_ptr(), key.data_ptr(), out.data_ptr(), b, p, h, w, ROUTES.index(plan.route),
            plan.parts, plan.segments, plan.tile_rows, stream,
        )
    cuda_build.check(rc, "zbuffer_min")
    return out


zbuffer_min.launches = 0
