"""Forward point splatting, the conditioning renderer — port of
`sgam_neurips22_tpu/geometry/splat.py`.

Every source pixel (every s-th with `splat_stride` s, phase-shifted per
source) is unprojected, moved into the target frame and projected. The
points are merged per target pixel by one of three collision rules:
- "nearest": one packed int32 key per point (12-bit quantised z above a
  19-bit point index) through the z-buffer scatter-min
  (`ops.zbuffer.zbuffer_min`, a CUDA kernel on the card);
- "nearest_exact": a scatter-min of the f32 z, then the smallest point
  index among the equal-z ties;
- "last": the reference's serial write order, pixel-major, by a
  scatter-max of each point's priority.
The last two are XLA scatters in JAX, outside any Pallas kernel, and
`scatter_reduce_` here. The winners' exact z and features come back in
one [z | rgb] row gather; at stride s > 1 empty pixels first take their
nearest 3x3 neighbour; zero pixels are filled with a 3x3 median; the
extrapolation mask marks what stays empty. Layout is NHWC, as in the JAX
package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from sgam_neurips22_tpu_torch.geometry.camera import inv3x3, matvec3, pixel2cam
from sgam_neurips22_tpu_torch.ops.zbuffer import IMAX, zbuffer_min

INDEX_BITS = 19  # the packed key's point-index field
COLLISIONS = ("nearest", "nearest_exact", "last")
FLOAT_MAX = torch.finfo(torch.float32).max  # the empty pixel of the nearest_exact scatter
FILL_EMPTY = 3.4e38  # an empty pixel's depth in fill_from_nearest_neighbor (JAX's f32 constant)


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


def phase_subsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """x [B, N, H, W, ...] -> [B, N, H//s, W//s, ...]: source k keeps the
    pixels (oy + s i, ox + s j), (oy, ox) = ((k // s) % s, k % s), so that
    s^2 sources cover every phase of the s x s cell (JAX
    render_projection_from_srcs, splat_stride)."""
    if s == 1:
        return x
    h, w = x.shape[2] // s, x.shape[3] // s
    return torch.stack([x[:, k, (k // s) % s::s, k % s::s][:, :h, :w] for k in range(x.shape[1])], dim=1)


def project_points(src_depths, tgt_intrinsics, src_intrinsics, src2tgt, src_masks=None, splat_stride: int = 1,
                   nearest: bool = True):
    """Target-view pixel and depth of every splatted source pixel.

    Args: src_depths [B, N, H, W]; tgt_intrinsics [B, 3, 3];
      src_intrinsics [B, N, 3, 3]; src2tgt [B, N, 4, 4];
      src_masks optional [B, N] (False/0 = padded source, no points);
      splat_stride: s, each source's pixels as `phase_subsample` keeps them;
      nearest: the nearest collision modes, in which points behind the
        camera are invalid (the reference's last-write mode keeps them).
    Returns:
      (pix [B, P, 2] int32 (x, y), z [B, P] f32, valid [B, P] bool),
      P = N*(H//s)*(W//s) in source-major order. pix is 0 where not valid.
    """
    b, n, h, w = src_depths.shape
    k_inv = inv3x3(src_intrinsics.reshape(b * n, 3, 3))
    pts = pixel2cam(src_depths.reshape(b * n, h, w), k_inv)  # [BN, H, W, 3]
    t = src2tgt.reshape(b * n, 4, 4)
    pts = matvec3(t[:, None, None, :3, :3], pts) + t[:, None, None, :3, 3]
    pts = phase_subsample(pts.reshape(b, n, h, w, 3), splat_stride)
    hw_pts = pts.shape[2] * pts.shape[3]
    pts = pts.reshape(b, n * hw_pts, 3)
    proj = matvec3(tgt_intrinsics[:, None], pts)
    zs = proj[..., 2]
    # pixel index = floor(u + 0.5), as the reference's (pix + 0.5).long();
    # bounds are tested on the float so that no out-of-range value is cast
    fxy = torch.floor(proj[..., :2] / zs[..., None] + 0.5)
    valid = (fxy[..., 0] >= 0) & (fxy[..., 0] < w) & (fxy[..., 1] >= 0) & (fxy[..., 1] < h)
    if nearest:
        valid = valid & (zs > 0)  # points behind the camera never win the z-buffer
    if src_masks is not None:
        valid = valid & src_masks.bool().repeat_interleave(hw_pts, dim=1)
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


def fill_from_nearest_neighbor(depth: torch.Tensor, feats: torch.Tensor):
    """The strided splat's one-pass hole fill (JAX
    `_fill_from_nearest_neighbor`): each empty pixel (depth <= 0) of depth
    [B, H, W, 1] takes the depth and features of its 3x3 neighbour with
    the smallest positive depth, the first in row-major order on ties;
    pixels with no such neighbour stay as they are. Selects only, so the
    result is bit-exact."""
    _, h, w, _ = depth.shape
    pad_d = F.pad(torch.where(depth <= 0.0, FILL_EMPTY, depth), (0, 0, 1, 1, 1, 1), value=FILL_EMPTY)
    pad_f = F.pad(feats, (0, 0, 1, 1, 1, 1))
    best_d, best_f = pad_d[:, :h, :w], pad_f[:, :h, :w]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                nd = pad_d[:, dy: dy + h, dx: dx + w]
                nearer = nd < best_d
                best_d = torch.where(nearer, nd, best_d)
                best_f = torch.where(nearer, pad_f[:, dy: dy + h, dx: dx + w], best_f)
    take = (depth <= 0.0) & (best_d < FILL_EMPTY)
    return torch.where(take, best_d, depth), torch.where(take, best_f, feats)


def last_priority(n: int, hw: int, device=None):
    """(priority [n*hw], its inverse permutation) of collision "last": the
    reference flattens points pixel-major, so point i = (source i // hw,
    pixel i % hw) of the source-major order writes at step
    (i % hw) * n + i // hw, and the highest step wins."""
    i = torch.arange(n * hw, device=device)
    pri = (i % hw) * n + i // hw
    inv = torch.empty_like(pri)
    inv[pri] = i
    return pri, inv


def _linear_pixels(pix, valid, h: int, w: int) -> torch.Tensor:
    """[B*P] int64 pixel ids over the whole batch (image b at b*h*w), 0 at
    an invalid point."""
    b = pix.shape[0]
    lin = torch.where(valid, pix[..., 1] * w + pix[..., 0], 0).long()
    return (lin + (torch.arange(b, device=pix.device) * (h * w))[:, None]).reshape(-1)


def _winners(pix, zs, valid, h: int, w: int, collision: str, n: int):
    """(has_point [B*h*w] bool, winner's index into the [B*P] points)."""
    b, p_count = zs.shape
    scene = torch.arange(b * h * w, device=zs.device) // (h * w)
    if collision == "nearest":
        p_local, key = packed_keys(pix, zs, valid, w)
        win = zbuffer_min(p_local.contiguous(), key.contiguous(), h, w).reshape(-1)
        has_point = win != IMAX
        return has_point, torch.where(has_point, scene * p_count + (win & ((1 << INDEX_BITS) - 1)), 0)
    lin, ok = _linear_pixels(pix, valid, h, w), valid.reshape(-1)
    if collision == "nearest_exact":
        z = zs.reshape(-1)
        win_z = torch.full((b * h * w,), FLOAT_MAX, device=z.device)
        win_z.scatter_reduce_(0, lin, torch.where(ok, z, FLOAT_MAX), "amin")
        # among equal-z ties the smallest point index
        none = b * p_count
        is_win = ok & (z == win_z[lin])
        idx = torch.where(is_win, torch.arange(none, device=z.device), none)
        win = torch.full((b * h * w,), none, device=z.device).scatter_reduce_(0, lin, idx, "amin")
        has_point = win != none
        return has_point, torch.where(has_point, win, 0)
    pri, inv = last_priority(n, p_count // n, zs.device)
    win = torch.full((b * h * w,), -1, device=zs.device)
    win.scatter_reduce_(0, lin, torch.where(ok, pri.repeat(b), -1), "amax")
    has_point = win >= 0
    return has_point, torch.where(has_point, scene * p_count + inv[win.clamp(min=0)], 0)


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
      collision: one of COLLISIONS (module docstring).
      splat_stride: s > 1 splats every s-th pixel of each source with the
        per-source phase offsets of `phase_subsample`, then fills the holes
        with `fill_from_nearest_neighbor` before the median (the raw_*
        outputs stay before both fills); "last" takes s = 1 only.
    """
    if collision not in COLLISIONS:
        raise ValueError(f"unknown collision mode {collision!r}")
    s = int(splat_stride)
    if s > 1 and collision == "last":
        raise ValueError("splat_stride > 1 requires collision='nearest'")
    b, n, h, w, c = src_features.shape
    pix, zs, valid = project_points(src_depths, tgt_intrinsics, src_intrinsics, src2tgt, src_masks, s,
                                    nearest=collision != "last")
    has_point, idx = _winners(pix, zs, valid, h, w, collision, n)
    # one [z | feats] row gather for the winners
    pay = torch.cat([zs.reshape(-1, 1), phase_subsample(src_features, s).reshape(-1, c)], dim=-1)
    won = torch.where(has_point[:, None], pay[idx], 0.0)
    raw_depth = won[:, :1].reshape(b, h, w, 1)
    raw_feats = won[:, 1:].reshape(b, h, w, c)

    fill_depth, fill_feats = raw_depth, raw_feats
    if s > 1:
        fill_depth, fill_feats = fill_from_nearest_neighbor(raw_depth, raw_feats)
    # median hole filling: only zero pixels take the median (per channel)
    merge_feats = torch.where(fill_feats == 0.0, median_blur_3x3(fill_feats), fill_feats)
    merge_depth = torch.where(fill_depth == 0.0, median_blur_3x3(fill_depth), fill_depth)
    if depth_range is not None:
        lo, hi = depth_range
        extrapolation = ~((merge_depth >= lo) & (merge_depth <= hi))
        merge_feats = torch.where(merge_depth >= hi, 0.0, merge_feats)
    else:
        extrapolation = merge_depth <= 0.0
    return SplatResult(merge_depth, merge_feats, extrapolation, raw_depth, raw_feats)
