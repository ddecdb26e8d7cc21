# Frozen copy of sgam_neurips22_tpu_torch/geometry/warp.py at commit e4e59b7, kept as the
# benchmark's plain reference: imports point into portbench.reference, and
# the hand kernels are replaced by the plain PyTorch versions of plain_ops.
"""Inverse warping: pull source pixels into the target view — port of
`sgam_neurips22_tpu/geometry/warp.py`.

`inverse_warp_multi_src`: several sources, nearest sampling, and per
pixel the source whose warped depth is closest to its own (the reference's
`InfiniteSceneGeneration.inverse_warping`), the map-requery path's warp.
The copy keeps only what the benchmark runs.

grid_sample here is a gather with torch's align_corners=False
unnormalization and zero padding; every float -> int32 index cast follows
XLA's semantics (`core.dtypes.to_int32`), so that a NaN or infinite
coordinate lands where it lands in JAX.
"""
from __future__ import annotations

import torch

from portbench.reference.dtypes import to_int32
from portbench.reference.camera import cam2pixel, inv3x3, matmul3, pixel2cam


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """torch grid_sample align_corners=False: ((coord + 1) * size - 1) / 2."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def _nearest_indices(grid: torch.Tensor, h: int, w: int):
    """(ix, iy, in_bounds) of grid_sample(nearest, zeros, align_corners=
    False) for normalized coords [..., 2], rounding half to even."""
    ix = to_int32(torch.round(_unnormalize(grid[..., 0], w)))
    iy = to_int32(torch.round(_unnormalize(grid[..., 1], h)))
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    return ix, iy, inb


def inverse_warp_multi_src(src_imgs, src_depths, tgt_depth, src_intrinsics, tgt_intrinsics, tgt2srcs):
    """Multi-source inverse warp with a |warped - src| depth z-buffer.

    Unprojects the target depth (rendered from the map), projects it into
    each source view (no z clamp, as the pipeline's copy of cam2pixel), and
    per pixel keeps the first source with the smallest |warped depth -
    source depth| among those that see the pixel in bounds and in front.
    The winner is decided from the projection alone (the reference's
    `sum(src + 2) > 0` occupancy test is exactly the in-bounds mask), and
    only its RGB is gathered, once, through the [N*H*W] source stack; the
    reference's (+2) - 2 round trip is kept, since it moves values by an
    f32 ULP.

    Args:
      src_imgs: [B, N, H, W, 3] in [-1, 1]; src_depths: [B, N, H, W];
      tgt_depth: [B, H, W]; src_intrinsics: [B, N, 3, 3];
      tgt_intrinsics: [B, 3, 3]; tgt2srcs: [B, N, 4, 4].
    Returns:
      warped [B, H, W, 3]; zeros where no source is valid.
    """
    b, n, h, w, c = src_imgs.shape
    cam_pts = pixel2cam(tgt_depth, inv3x3(tgt_intrinsics))  # [B, H, W, 3]
    cam_pts_r = cam_pts.repeat_interleave(n, dim=0)  # [B*N, H, W, 3]
    proj = matmul3(src_intrinsics, tgt2srcs[..., :3, :]).reshape(b * n, 3, 4)
    coords, warped_src_depth = cam2pixel(cam_pts_r, proj[..., :3], proj[..., 3], clamp_z=None)
    ix, iy, inb = _nearest_indices(coords, h, w)
    inb = inb.reshape(b, n, h, w)
    warped_src_depth = warped_src_depth.reshape(b, n, h, w)
    valid = inb & (warped_src_depth >= 0.0)
    key = torch.where(valid, (warped_src_depth - src_depths).abs(), float("inf"))
    # the first source of the smallest key wins, as the reference's strict '<' scan
    winner = torch.argmin(key, dim=1)  # [B, H, W]
    any_valid = valid.any(dim=1)
    lin_src = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, n, h, w)
    lin_win = torch.gather(lin_src, 1, winner[:, None])[:, 0]
    lin = (winner * (h * w) + lin_win).reshape(b, h * w, 1)
    picked = torch.gather(src_imgs.reshape(b, n * h * w, c), 1, lin.expand(-1, -1, c)).reshape(b, h, w, c)
    picked = (picked + 2.0) - 2.0
    return torch.where(any_valid[..., None], picked, 0.0)
