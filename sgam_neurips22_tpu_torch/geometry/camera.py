"""Camera geometry primitives (torch, NHWC) — port of
`sgam_neurips22_tpu/geometry/camera.py`.

The pixel lattice is (x=j, y=i, 1) in units of pixel index, as in the
reference's `set_id_grid`. Normalized pixel coordinates are in [-1, 1]
with the align-corners convention 2*(u/(W-1)) - 1 of the reference's
`cam2pixel`. A division by a constant divides by a tensor
(`core.dtypes.div_scalar`), so that CUDA rounds it as the CPU and JAX do.
"""
from __future__ import annotations

import torch

from sgam_neurips22_tpu_torch.core.dtypes import div_scalar

ALL_ROWS = (0, 1, 2)
# the rows that XLA:CPU evaluates as a fused multiply-add chain when the
# contraction runs over the matrix's first index ("ji,hwj->hwi"); it sums
# the other rows' rounded products in order
XLA_TRANSPOSED_ROWS = (2,)


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel lattice [H, W, 3] with rows (x, y, 1)."""
    y, x = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def matvec3(m: torch.Tensor, v: torch.Tensor, fma_rows: tuple = ALL_ROWS) -> torch.Tensor:
    """m [..., 3, 3] applied to v [..., 3], broadcast over the leading dims.

    Evaluated as XLA:CPU evaluates the JAX package's 3-term einsums: per
    row a chain of fused multiply-adds in index order,
    fma(m2, v2, fma(m1, v1, m0 * v0)). Each fma is computed in float64 (the
    product of two f32 values is exact there; the f64 sum rounds once before
    the f32 rounding, which changes the result with probability ~2^-29), so
    the CPU and the GPU give the same bits, whatever their BLAS does. Rows
    outside `fma_rows` sum the f32-rounded products in order instead
    (XLA_TRANSPOSED_ROWS)."""
    md, vd = m.double(), v.double()
    rows = []
    for i in range(3):
        acc = (md[..., i, 0] * vd[..., 0]).float()
        for j in (1, 2):
            prod = md[..., i, j] * vd[..., j]
            acc = (prod + acc.double()).float() if i in fma_rows else acc + prod.float()
        rows.append(acc)
    return torch.stack(rows, dim=-1)


def matmul3(m: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """m [..., 3, 3] @ a [..., 3, K], column by column through matvec3 (a
    batched 3x3 matrix product of the JAX package, as XLA:CPU evaluates it)."""
    return torch.stack([matvec3(m, a[..., k]) for k in range(a.shape[-1])], dim=-1)


def pixel2cam(depth: torch.Tensor, k_inv: torch.Tensor) -> torch.Tensor:
    """Unproject depth [B, H, W] through k_inv [B, 3, 3] -> points [B, H, W, 3]."""
    b, h, w = depth.shape
    pix = pixel_grid(h, w, depth.dtype, depth.device)
    rays = matvec3(k_inv[:, None, None], pix[None])
    return rays * depth[..., None]


def cam2pixel(cam_points: torch.Tensor, rot: torch.Tensor, tr: torch.Tensor, clamp_z: float | None = 1e-3):
    """Project camera-frame points [B, H, W, 3] through [rot | tr] (rot
    [B, 3, 3] already holds the intrinsics, K @ R; tr [B, 3] or [B, 3, 1])
    and normalize to [-1, 1]. clamp_z, if not None, clamps z from below
    before the division (the reference's warp clamps at 1e-3; the pipeline's
    copy does not clamp). Returns (coords [B, H, W, 2], z [B, H, W])."""
    _, h, w, _ = cam_points.shape
    if tr.dim() == 3:
        tr = tr[..., 0]
    p = matvec3(rot[:, None, None], cam_points) + tr[:, None, None, :]
    x, y, z = p.unbind(-1)
    zd = z.clamp(min=clamp_z) if clamp_z is not None else z
    x_norm = div_scalar(2.0 * (x / zd), w - 1) - 1.0
    y_norm = div_scalar(2.0 * (y / zd), h - 1) - 1.0
    return torch.stack([x_norm, y_norm], dim=-1), z


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate / determinant) 3x3 inverse, any batch shape."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca, cb, cc = e * i - f * h, c * h - b * i, b * f - c * e
    cd, ce, cf = f * g - d * i, a * i - c * g, c * d - a * f
    cg, ch, ci = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * ca + b * cd + c * cg
    adj = torch.stack(
        [
            torch.stack([ca, cb, cc], dim=-1),
            torch.stack([cd, ce, cf], dim=-1),
            torch.stack([cg, ch, ci], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def pose_matrix(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] rigid transform from rotation [..., 3, 3] + translation [..., 3]."""
    out = torch.zeros((*r.shape[:-2], 4, 4), dtype=r.dtype, device=r.device)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def plane_z_depth(k, w2c, plane_n, plane_d, hw: tuple, lo: float, hi: float) -> torch.Tensor:
    """Analytic z-depth [H, W] of the world plane {x : n.x = d} seen from
    the pose w2c [4, 4] with intrinsics k [3, 3], clamped to [lo, hi]: the
    coherent synthetic scene of the map-requery bench, in which every
    camera's depth agrees with every other camera's. plane_n [3] is the
    unit normal, plane_d a 0-dim tensor."""
    h, w = hw
    r_c2w = w2c[:3, :3].T
    cam_center = -matvec3(r_c2w, w2c[:3, 3])
    pix = pixel_grid(h, w, k.dtype, k.device)
    rays_cam = matvec3(inv3x3(k), pix)  # z-component == 1
    rays_w = matvec3(r_c2w, rays_cam)
    n = plane_n.double()
    denom = (n[0] * rays_w[..., 0].double()).float()
    for i in (1, 2):
        denom = (n[i] * rays_w[..., i].double() + denom.double()).float()
    num = plane_d - matvec3(plane_n.expand(3, 3), cam_center)[0]
    # z-depth along the camera axis equals the ray parameter: the camera-
    # frame ray has unit z
    safe = torch.where(denom.abs() < 1e-6, torch.sign(denom) * 1e-6 + 1e-12, denom)
    return torch.clamp(num / safe, lo, hi)


def _ray_scale(k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """sqrt(f^2 + (cx - y - .5)^2 + (cy - x - .5)^2) / f over the
    reference's transposed meshgrid (xs[i, j] = i along W rows, ys[i, j] =
    j), quirk included (inference_pipeline.py:840-858)."""
    f = k[0, 0]
    xs = torch.arange(w, dtype=torch.float32, device=k.device)[:, None].expand(w, h)
    ys = torch.arange(h, dtype=torch.float32, device=k.device)[None, :].expand(w, h)
    return torch.sqrt(f**2 + (k[0, 2] - ys - 0.5) ** 2 + (k[1, 2] - xs - 0.5) ** 2) / f


def ray_depth_to_z(depth: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Ray (Euclidean) depth -> z-depth."""
    h, w = depth.shape[-2:]
    return depth / _ray_scale(k, h, w)


def z_depth_to_ray(depth: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """z-depth -> ray depth."""
    h, w = depth.shape[-2:]
    return depth * _ray_scale(k, h, w)
