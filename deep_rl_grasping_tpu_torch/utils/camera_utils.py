"""Pinhole camera intrinsics (the port's own copy of
deep_rl_grasping_tpu/utils/camera_utils.py; reference:
manipulation_main/common/camera_utils.py).

The reference converts an OpenCV-style K into an OpenGL projection matrix and
reads back a z-buffer (sensor.py:148-167). The TPU renderer ray-casts directly
from K, which yields the same metric depth `Z_c` without the GL round trip; the
GL construction is kept for parity testing.
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class CameraInfo:
    height: int
    width: int
    K: np.ndarray  # 3x3
    near: float = 0.02
    far: float = 2.0

    @classmethod
    def from_dict(cls, d):
        return cls(
            height=int(d["height"]),
            width=int(d["width"]),
            K=np.reshape(np.asarray(d["K"], np.float32), (3, 3)),
            near=float(d.get("near", 0.02)),
            far=float(d.get("far", 2.0)),
        )

    def to_dict(self):
        return {
            "height": self.height,
            "width": self.width,
            "K": self.K.reshape(-1).tolist(),
            "near": self.near,
            "far": self.far,
        }


def gl_ortho(left, right, bottom, top, near, far):
    """OpenGL glOrtho matrix (parity with reference sensor.py:_gl_ortho)."""
    ortho = np.diag(
        [2.0 / (right - left), 2.0 / (top - bottom), -2.0 / (far - near), 1.0]
    )
    ortho[0, 3] = -(right + left) / (right - left)
    ortho[1, 3] = -(top + bottom) / (top - bottom)
    ortho[2, 3] = -(far + near) / (far - near)
    return ortho


def build_projection_matrix(height, width, K, near, far):
    """OpenCV K -> OpenGL projection (parity with sensor.py:_build_projection_matrix)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    perspective = np.array(
        [
            [fx, 0.0, -cx, 0.0],
            [0.0, fy, -cy, 0.0],
            [0.0, 0.0, near + far, near * far],
            [0.0, 0.0, -1.0, 0.0],
        ]
    )
    return np.matmul(gl_ortho(0.0, width, height, 0.0, near, far), perspective)
