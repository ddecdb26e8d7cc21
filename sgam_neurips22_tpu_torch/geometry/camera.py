"""Camera geometry primitives (torch, NHWC) — port of
`sgam_neurips22_tpu/geometry/camera.py`.

The pixel lattice is (x=j, y=i, 1) in units of pixel index, as in the
reference's `set_id_grid`.
"""
from __future__ import annotations

import torch


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel lattice [H, W, 3] with rows (x, y, 1)."""
    y, x = torch.meshgrid(
        torch.arange(h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m [..., 3, 3] applied to v [..., 3], broadcast over the leading dims.

    Evaluated as XLA:CPU evaluates the JAX package's 3-term einsums: per
    row a chain of fused multiply-adds in index order,
    fma(m2, v2, fma(m1, v1, m0 * v0)). Each fma is computed in float64 (the
    product of two f32 values is exact there; the f64 sum rounds once before
    the f32 rounding, which changes the result with probability ~2^-29), so
    the CPU and the GPU give the same bits, whatever their BLAS does."""
    md, vd = m.double(), v.double()
    rows = []
    for i in range(3):
        acc = (md[..., i, 0] * vd[..., 0]).float()
        for j in (1, 2):
            acc = (md[..., i, j] * vd[..., j] + acc.double()).float()
        rows.append(acc)
    return torch.stack(rows, dim=-1)


def pixel2cam(depth: torch.Tensor, k_inv: torch.Tensor) -> torch.Tensor:
    """Unproject depth [B, H, W] through k_inv [B, 3, 3] -> points [B, H, W, 3]."""
    b, h, w = depth.shape
    pix = pixel_grid(h, w, depth.dtype, depth.device)
    rays = matvec3(k_inv[:, None, None], pix[None])
    return rays * depth[..., None]


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
