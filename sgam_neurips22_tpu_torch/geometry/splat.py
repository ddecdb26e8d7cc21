"""Forward point splatting, the conditioning renderer — port of
`sgam_neurips22_tpu/geometry/splat.py` for `collision="nearest"` and
`splat_stride=1`.

Every source pixel is unprojected, moved into the target frame and
projected; one packed int32 key per point (12-bit quantised z above a
19-bit point index) goes through the z-buffer scatter-min
(`ops.zbuffer.zbuffer_min`, a CUDA kernel on the card); the winners' exact
z and features come back in one [z | rgb] row gather; zero pixels are
filled with a 3x3 median; the extrapolation mask marks what stays empty.
Layout is NHWC, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sgam_neurips22_tpu_torch.geometry.camera import inv3x3, matvec3, pixel2cam
from sgam_neurips22_tpu_torch.ops.zbuffer import IMAX, zbuffer_min

INDEX_BITS = 19  # the packed key's point-index field


class SplatResult(NamedTuple):
    depth: torch.Tensor  # [B, H, W, 1] merged target-view z-depth
    features: torch.Tensor  # [B, H, W, C] merged target-view features
    extrapolation_mask: torch.Tensor  # [B, H, W, 1] bool, True where unseen
    raw_depth: torch.Tensor  # [B, H, W, 1] before the median fill
    raw_features: torch.Tensor  # [B, H, W, C] before the median fill


def median_blur_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median with zero padding over x [B, H, W, C]: McGuire's
    19-exchange median-of-9 network, elementwise min/max only (sorted
    index 4 of 9 values, the lower median torch.median gives)."""
    _, h, w, _ = x.shape
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    p = [padded[:, dy: dy + h, dx: dx + w, :] for dy in range(3) for dx in range(3)]

    def s2(i, j):
        p[i], p[j] = torch.minimum(p[i], p[j]), torch.maximum(p[i], p[j])

    s2(1, 2); s2(4, 5); s2(7, 8)
    s2(0, 1); s2(3, 4); s2(6, 7)
    s2(1, 2); s2(4, 5); s2(7, 8)
    s2(0, 3); s2(5, 8); s2(4, 7)
    s2(3, 6); s2(1, 4); s2(2, 5)
    s2(4, 7); s2(4, 2); s2(6, 4)
    s2(4, 2)
    return p[4]


def project_points(src_depths, tgt_intrinsics, src_intrinsics, src2tgt, src_masks=None):
    """Target-view pixel and depth of every source pixel.

    Args: src_depths [B, N, H, W]; tgt_intrinsics [B, 3, 3];
      src_intrinsics [B, N, 3, 3]; src2tgt [B, N, 4, 4];
      src_masks optional [B, N] (False/0 = padded source, no points).
    Returns:
      (pix [B, P, 2] int32 (x, y), z [B, P] f32, valid [B, P] bool),
      P = N*H*W in source-major order. pix is 0 where not valid.
    """
    b, n, h, w = src_depths.shape
    k_inv = inv3x3(src_intrinsics.reshape(b * n, 3, 3))
    pts = pixel2cam(src_depths.reshape(b * n, h, w), k_inv)  # [BN, H, W, 3]
    t = src2tgt.reshape(b * n, 4, 4)
    pts = matvec3(t[:, None, None, :3, :3], pts) + t[:, None, None, :3, 3]
    pts = pts.reshape(b, n * h * w, 3)
    proj = matvec3(tgt_intrinsics[:, None], pts)
    zs = proj[..., 2]
    # pixel index = floor(u + 0.5), as the reference's (pix + 0.5).long();
    # bounds are tested on the float so that no out-of-range value is cast
    fxy = torch.floor(proj[..., :2] / zs[..., None] + 0.5)
    valid = (
        (fxy[..., 0] >= 0) & (fxy[..., 0] < w) & (fxy[..., 1] >= 0) & (fxy[..., 1] < h)
        & (zs > 0)  # points behind the camera never win the z-buffer
    )
    if src_masks is not None:
        valid = valid & src_masks.bool().repeat_interleave(h * w, dim=1)
    pix = torch.where(valid[..., None], fxy, 0.0).to(torch.int32)
    return pix, zs, valid


def packed_keys(pix, z, valid, w: int):
    """(linear pixel id [B, P], packed key [B, P]) for the z-buffer: z
    quantised to 12 bits over each image's valid range above the 19-bit
    point index; invalid points get pixel 0 and key INT32_MAX."""
    _, p_count = z.shape
    if p_count >= (1 << INDEX_BITS):
        raise ValueError("packed nearest-splat supports < 2^19 points per image")
    inf = torch.tensor(float("inf"), device=z.device)
    z_lo = torch.where(valid, z, inf).amin(dim=1, keepdim=True)
    z_hi = torch.where(valid, z, -inf).amax(dim=1, keepdim=True)
    scale = 4095.0 / torch.clamp(z_hi - z_lo, min=1e-6)
    z_q = torch.clamp((z - z_lo) * scale, 0, 4095).to(torch.int32)
    idx = torch.arange(p_count, dtype=torch.int32, device=z.device)[None, :]
    key = torch.where(valid, (z_q << INDEX_BITS) | idx, IMAX)
    p_local = torch.where(valid, pix[..., 1] * w + pix[..., 0], 0)
    return p_local, key


def render_projection_from_srcs(
    src_features: torch.Tensor,
    src_depths: torch.Tensor,
    tgt_intrinsics: torch.Tensor,
    src_intrinsics: torch.Tensor,
    src2tgt: torch.Tensor,
    src_masks: torch.Tensor | None = None,
    depth_range: tuple[float, float] | None = None,
    collision: str = "nearest",
    splat_stride: int = 1,
) -> SplatResult:
    """Forward-splat N source RGB(-D) views into the target view.

    Args:
      src_features: [B, N, H, W, C]; src_depths: [B, N, H, W];
      tgt_intrinsics: [B, 3, 3]; src_intrinsics: [B, N, 3, 3];
      src2tgt: [B, N, 4, 4] source camera -> target camera;
      src_masks: optional [B, N] validity of each (padded) source;
      depth_range: optional (lo, hi); outside it is extrapolation, and
        features are zeroed where z >= hi.
      collision, splat_stride: only "nearest" and 1 are ported.
    """
    if collision != "nearest" or splat_stride != 1:
        raise NotImplementedError(
            f"collision={collision!r}, splat_stride={splat_stride}: only "
            "'nearest' at stride 1 is ported (ROADMAP.md, queue item (b): "
            "the remaining splat modes)"
        )
    b, n, h, w, c = src_features.shape
    pix, zs, valid = project_points(src_depths, tgt_intrinsics, src_intrinsics, src2tgt, src_masks)
    p_count = n * h * w
    p_local, key = packed_keys(pix, zs, valid, w)
    win = zbuffer_min(p_local.contiguous(), key.contiguous(), h, w).reshape(-1)

    # winner's global point id from (pixel's batch element, 19-bit index)
    has_point = win != IMAX
    scene = torch.arange(b * h * w, device=win.device) // (h * w)
    safe_idx = torch.where(has_point, scene * p_count + (win & ((1 << INDEX_BITS) - 1)), 0)
    # one [z | feats] row gather for the winners
    pay = torch.cat([zs.reshape(-1, 1), src_features.reshape(-1, c)], dim=-1)
    won = torch.where(has_point[:, None], pay[safe_idx], 0.0)
    raw_depth = won[:, :1].reshape(b, h, w, 1)
    raw_feats = won[:, 1:].reshape(b, h, w, c)

    # median hole filling: only zero pixels take the median (per channel)
    merge_feats = torch.where(raw_feats == 0.0, median_blur_3x3(raw_feats), raw_feats)
    merge_depth = torch.where(raw_depth == 0.0, median_blur_3x3(raw_depth), raw_depth)
    if depth_range is not None:
        lo, hi = depth_range
        extrapolation = ~((merge_depth >= lo) & (merge_depth <= hi))
        merge_feats = torch.where(merge_depth >= hi, 0.0, merge_feats)
    else:
        extrapolation = merge_depth <= 0.0
    return SplatResult(merge_depth, merge_feats, extrapolation, raw_depth, raw_feats)
