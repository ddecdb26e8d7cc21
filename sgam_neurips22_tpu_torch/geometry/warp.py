"""Inverse warping: pull source pixels into the target view — port of
`sgam_neurips22_tpu/geometry/warp.py`.

- `inverse_warp`: one source, bilinear sampling and a depth-consistency
  mask (the reference's point_rendering/warp.py).
- `inverse_warp_multi_src`: several sources, nearest sampling, and per
  pixel the source whose warped depth is closest to its own (the
  reference's `InfiniteSceneGeneration.inverse_warping`), the map-requery
  path's warp.

grid_sample here is a gather with torch's align_corners=False
unnormalization and zero padding; every float -> int32 index cast follows
XLA's semantics (`core.dtypes.to_int32`), so that a NaN or infinite
coordinate lands where it lands in JAX.
"""
from __future__ import annotations

import torch

from sgam_neurips22_tpu_torch.core.dtypes import to_int32
from sgam_neurips22_tpu_torch.geometry.camera import cam2pixel, inv3x3, matmul3, pixel2cam


def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """torch grid_sample align_corners=False: ((coord + 1) * size - 1) / 2."""
    return ((coord + 1.0) * size - 1.0) / 2.0


def _nearest_indices(grid: torch.Tensor, h: int, w: int):
    """(ix, iy, in_bounds) of grid_sample(nearest, zeros, align_corners=
    False) for normalized coords [..., 2], rounding half to even. The one
    home of this index math: the winner gather of inverse_warp_multi_src
    relies on the same mask and indices as grid_sample_nearest."""
    ix = to_int32(torch.round(_unnormalize(grid[..., 0], w)))
    iy = to_int32(torch.round(_unnormalize(grid[..., 1], h)))
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    return ix, iy, inb


def _gather_pixels(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C] at the (clamped) pixels iy, ix [B, ...] -> [B, ..., C],
    zero where (iy, ix) lies outside the image."""
    b, h, w, c = img.shape
    inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    lin = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long().reshape(b, -1, 1)
    vals = torch.gather(img.reshape(b, h * w, c), 1, lin.expand(-1, -1, c)).reshape(*iy.shape, c)
    return torch.where(inb[..., None], vals, 0.0)


def grid_sample_nearest(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour grid sample with zero padding: img [B, H, W, C],
    grid [B, Ho, Wo, 2] normalized (x, y) -> [B, Ho, Wo, C]."""
    _, h, w, _ = img.shape
    ix, iy, _ = _nearest_indices(grid, h, w)
    return _gather_pixels(img, iy, ix)


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear grid sample with zero padding, align_corners=False: img
    [B, H, W, C], grid [B, Ho, Wo, 2] normalized (x, y)."""
    _, h, w, _ = img.shape
    fx, fy = _unnormalize(grid[..., 0], w), _unnormalize(grid[..., 1], h)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
    x0i, y0i = to_int32(x0), to_int32(y0)
    return (
        _gather_pixels(img, y0i, x0i) * (1 - wx) * (1 - wy)
        + _gather_pixels(img, y0i, x0i + 1) * wx * (1 - wy)
        + _gather_pixels(img, y0i + 1, x0i) * (1 - wx) * wy
        + _gather_pixels(img, y0i + 1, x0i + 1) * wx * wy
    )


def inverse_warp(src_img, tgt_depth, src_depth, pose, tgt_intrinsics, src_intrinsics, depth_threshold: float = 1.0):
    """Single-source inverse warp with a depth-consistency mask.

    Args:
      src_img: [B, H, W, C]; tgt_depth, src_depth: [B, H, W];
      pose: [B, 3, 4] target camera -> source camera; intrinsics [B, 3, 3].
    Returns:
      (projected image [B, H, W, C], valid [B, H, W, 1] bool).
    """
    cam_pts = pixel2cam(tgt_depth, inv3x3(tgt_intrinsics))
    proj = matmul3(src_intrinsics, pose)  # [B, 3, 4]
    coords, warped_src_depth = cam2pixel(cam_pts, proj[..., :3], proj[..., 3])
    valid_depth = (warped_src_depth - src_depth) <= depth_threshold
    projected = grid_sample_bilinear(src_img, coords)
    valid_pts = coords.abs().amax(dim=-1) <= 1.0
    valid = (valid_pts & valid_depth)[..., None]
    return projected * valid, valid


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
