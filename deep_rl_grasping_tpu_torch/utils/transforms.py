"""Quaternion / rotation math in PyTorch (port of the parts of
deep_rl_grasping_tpu/utils/transforms.py that the evaluation path uses).

Quaternion convention: [x, y, z, w]. All functions broadcast over leading axes.
"""

from __future__ import annotations

import math

import torch


def quat_normalize(q, eps=1e-12):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_matrix(q):
    """Unit quaternion -> 3x3 rotation matrix (broadcasts over leading dims)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def random_quaternion(u3):
    """Uniform random unit quaternion from 3 uniforms in [0,1) (Shoemake)."""
    r1 = torch.sqrt(1.0 - u3[..., 0])
    r2 = torch.sqrt(u3[..., 0])
    t1 = 2.0 * math.pi * u3[..., 1]
    t2 = 2.0 * math.pi * u3[..., 2]
    return torch.stack(
        [torch.sin(t1) * r1, torch.cos(t1) * r1, torch.sin(t2) * r2, torch.cos(t2) * r2],
        dim=-1,
    )

