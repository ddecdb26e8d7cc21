"""Conditioning construction — port of `sgam_neurips22_tpu/models/conditioning.py`:
warp the source views into the target frame and encode depth as
disparity, over NHWC batches. Two renderers: the forward point splat from
the source views, or map re-query, where the batch already carries the
target view warped from the map (`warped_tgt_features`, `warped_tgt_depth`)
and the splat is skipped."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sgam_neurips22_tpu_torch.geometry.camera import pose_matrix
from sgam_neurips22_tpu_torch.geometry.codec import get_codec
from sgam_neurips22_tpu_torch.geometry.splat import render_projection_from_srcs


class Conditioning(NamedTuple):
    x: torch.Tensor  # [B, H, W, 4] warped RGB + warped disparity
    x_dst: torch.Tensor  # [B, H, W, 4] GT RGB + GT disparity
    extrapolation_mask: torch.Tensor  # [B, H, W, 1] bool
    warped_disparity: torch.Tensor  # [B, H, W, 1] in [-1, 1] (-2 masked)


def get_x(
    batch: dict,
    dataset: str,
    depth_range: Optional[tuple] = None,
    collision: str = "nearest",
    splat_stride: int = 1,
) -> Conditioning:
    """Build (conditioning, target) pairs from an NHWC batch of tensors:
    dst_img [B, H, W, 3], dst_depth [B, H, W], src_imgs [B, N, H, W, 3],
    src_depths [B, N, H, W], Ks [B, N, 3, 3], R_rels [B, N, 3, 3],
    t_rels [B, N, 3], optional src_masks [B, N]; or, for map re-query,
    warped_tgt_features [B, H, W, 3] and warped_tgt_depth [B, H, W] in
    place of the sources (pixels of depth <= 0 are extrapolated)."""
    codec = get_codec(dataset)
    if "warped_tgt_features" in batch:
        feats = batch["warped_tgt_features"]
        warped_depth = batch["warped_tgt_depth"][..., None]
        extrapolation = warped_depth <= 0.0
    else:
        res = render_projection_from_srcs(
            batch["src_imgs"],
            batch["src_depths"],
            batch["Ks"][:, 0],
            batch["Ks"],
            pose_matrix(batch["R_rels"], batch["t_rels"]),
            src_masks=batch.get("src_masks"),
            depth_range=depth_range,
            collision=collision,
            splat_stride=splat_stride,
        )
        feats, warped_depth, extrapolation = res.features, res.depth, res.extrapolation_mask
    gt_disparity = codec.encode(batch["dst_depth"])[..., None]
    warped_disparity = codec.encode_masked(warped_depth, extrapolation)
    x = torch.cat([feats, warped_disparity], dim=-1)
    x_dst = torch.cat([batch["dst_img"], gt_disparity], dim=-1)
    return Conditioning(x, x_dst, extrapolation, warped_disparity)
