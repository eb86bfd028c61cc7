"""Action decoding for the full continuous task (port of the parts of
deep_rl_grasping_tpu/envs/actuator.py that this task uses).

Continuous full env: Box(-1,1,(5,)) = (dx, dy, dz, dyaw, open/close). The
reference denormalizes with a MinMaxScaler whose inverse transform is
`action * high` (actuator.py:54-78).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

CMD_MOVE = 0
CMD_OPEN = 1
CMD_CLOSE = 2


@dataclass(frozen=True)
class ActuatorSpec:
    simplified: bool
    discrete: bool
    max_translation: float
    max_yaw_rotation: float
    discrete_step: float
    yaw_step: float
    num_actions_pad: int
    include_robot_height: bool

    @classmethod
    def from_config(cls, config):
        r = config["robot"]
        return cls(
            simplified=bool(config["simplified"]),
            discrete=bool(r["discrete"]),
            max_translation=float(r["max_translation"]),
            max_yaw_rotation=float(r["max_yaw_rotation"]),
            discrete_step=float(r["step_size"]),
            yaw_step=float(r["yaw_step"]),
            num_actions_pad=int(r.get("num_actions_pad", 2)),
            include_robot_height=bool(r.get("include_robot_height", False)),
        )

    @property
    def action_dim(self):
        if self.discrete:
            return 1
        return 3 if self.simplified else 5


def decode_action(spec: ActuatorSpec, action, gripper_close):
    """Batched continuous full-task decode (actuator.py:91-123): returns
    translation (B,3), yaw rotation (B,) and command (B,) int.

    Open requests are ignored while open and close requests while closed;
    a gripper toggle replaces the move."""
    if spec.simplified or spec.discrete:
        raise NotImplementedError("the port decodes the full continuous task only")
    mt, my = spec.max_translation, spec.max_yaw_rotation
    high = torch.tensor([mt, mt, mt, my, 1.0], dtype=torch.float32, device=action.device)
    a = action.to(torch.float32) * high
    translation, yaw, open_close = a[:, :3], a[:, 3], a[:, 4]
    length = torch.linalg.vector_norm(translation, dim=-1, keepdim=True)
    scale = torch.where(length > mt, mt / torch.clamp(length, min=1e-9), torch.ones_like(length))
    translation = translation * scale
    yaw = torch.where(yaw > my, torch.full_like(yaw, my), yaw)
    cmd = torch.where(
        (open_close > 0.0) & gripper_close, CMD_OPEN,
        torch.where((open_close < 0.0) & ~gripper_close, CMD_CLOSE, CMD_MOVE))
    return translation, yaw, cmd


def actuator_obs(spec: ActuatorSpec, width, height):
    """Opening-width observation (actuator.py:43-52), (B, 1) or (B, 2)."""
    if spec.include_robot_height:
        return torch.stack([width / 0.05, height], -1)
    return (width / 0.1)[:, None]
