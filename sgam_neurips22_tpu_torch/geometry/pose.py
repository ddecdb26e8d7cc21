"""Pose parameterizations: Euler angles, quaternions and 6-DoF vectors to
rotation matrices, batched — port of `sgam_neurips22_tpu/geometry/pose.py`."""
from __future__ import annotations

import torch


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """[B, 3] (rx, ry, rz) radians -> [B, 3, 3], R = Rx @ Ry @ Rz."""
    x, y, z = angle.unbind(1)
    zeros, ones = torch.zeros_like(z), torch.ones_like(z)
    cz, sz = torch.cos(z), torch.sin(z)
    zmat = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones], dim=1).reshape(-1, 3, 3)
    cy, sy = torch.cos(y), torch.sin(y)
    ymat = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy], dim=1).reshape(-1, 3, 3)
    cx, sx = torch.cos(x), torch.sin(x)
    xmat = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx], dim=1).reshape(-1, 3, 3)
    return xmat @ ymat @ zmat


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """[B, 3] imaginary quaternion coefficients (w recovered for unit norm)
    -> [B, 3, 3]."""
    q = torch.cat([torch.ones_like(quat[:, :1]), quat], dim=1)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    w, x, y, z = q.unbind(1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=1,
    ).reshape(-1, 3, 3)


def pose_vec2mat(vec: torch.Tensor, rotation_mode: str = "euler") -> torch.Tensor:
    """[B, 6] (tx, ty, tz, rx, ry, rz) -> [B, 3, 4]."""
    if rotation_mode == "euler":
        rot_mat = euler2mat(vec[:, 3:])
    elif rotation_mode == "quat":
        rot_mat = quat2mat(vec[:, 3:])
    else:
        raise ValueError(rotation_mode)
    return torch.cat([rot_mat, vec[:, :3, None]], dim=2)
