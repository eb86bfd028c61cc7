"""Quaternion / rotation math in PyTorch (port of the parts of
deep_rl_grasping_tpu/utils/transforms.py that the evaluation path and the
gym adapter use).

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



def quat_mul(q1, q2):
    """Hamilton product q1 * q2 (apply q2 first, then q1), [x, y, z, w]."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)


def quat_from_euler(roll, pitch, yaw):
    """Static-axes xyz euler angles ('sxyz', float32) -> quaternion
    [x, y, z, w] (transformations.quaternion_from_euler)."""
    roll, pitch, yaw = (torch.as_tensor(a, dtype=torch.float32) for a in (roll, pitch, yaw))
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([sr * cp * cy - cr * sp * sy, cr * sp * cy + sr * cp * sy,
                        cr * cp * sy - sr * sp * cy, cr * cp * cy + sr * sp * sy], -1)
