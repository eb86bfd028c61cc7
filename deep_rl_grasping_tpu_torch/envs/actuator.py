"""Action decoding, batched over the env axis (port of
deep_rl_grasping_tpu/envs/actuator.py).

* Continuous full task:   Box(-1,1,(5,)) = (dx, dy, dz, dyaw, open/close)
* Continuous simplified:  Box(-1,1,(3,)) = (dx, dy, dyaw), constant 5 mm descent
* Discrete full task:     Discrete(11), the reference's lookup table
                          (actuator.py:106-115)
* Discrete simplified:    Discrete(3 * num_actions_pad): one branch moves
                          per step, by a linear bin (actuator.py:126-147)
* Branched (BDQ):         one bin per action dimension, all applied at once:
                          3 branches on the simplified task, 5 on the full
                          task with the open/close middle bin a no-op

The reference denormalizes with a MinMaxScaler whose inverse transform is
`action * high` (actuator.py:54-78).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

CMD_MOVE = 0
CMD_OPEN = 1
CMD_CLOSE = 2
# the simplified task's constant descent per step (actuator.py:148-149)
SIMPLIFIED_DESCENT = 0.005


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

    @property
    def num_discrete_actions(self):
        if self.simplified:
            return 3 * self.num_actions_pad
        return 11


def _clip(translation, yaw, mt, my):
    """Norm-clip the translation; clamp the yaw on its positive side only
    (actuator.py:91-98 rescales only when yaw > max)."""
    length = torch.linalg.vector_norm(translation, dim=-1, keepdim=True)
    scale = torch.where(length > mt, mt / torch.clamp(length, min=1e-9), torch.ones_like(length))
    return translation * scale, torch.where(yaw > my, torch.full_like(yaw, my), yaw)


def full_discrete_table(spec: ActuatorSpec, device="cpu"):
    """The full task's Discrete(11) rows (dx, dy, dz, dyaw, open/close):
    no-op, +-x, +-y, +-z, +-yaw, open, close (actuator.py:106-115)."""
    s, y = spec.discrete_step, spec.yaw_step
    t = torch.zeros((11, 5), dtype=torch.float32, device=device)
    for row, (col, val) in enumerate(((0, s), (0, -s), (1, s), (1, -s), (2, s), (2, -s),
                                      (3, y), (3, -y), (4, s), (4, -s)), start=1):
        t[row, col] = val
    return t


def _descent(like):
    return torch.full_like(like, SIMPLIFIED_DESCENT)


def decode_action(spec: ActuatorSpec, action, gripper_close):
    """Batched decode (actuator.py:87-136): returns translation (B,3), yaw
    rotation (B,) and command (B,) int. Continuous actions are (B, 3) or
    (B, 5); discrete ones (B,) ints.

    Open requests are ignored while open and close requests while closed;
    a gripper toggle replaces the move. The simplified task only moves."""
    mt, my = spec.max_translation, spec.max_yaw_rotation
    if spec.simplified:
        if spec.discrete:
            a = action.to(torch.int64).reshape(-1)
            pads = spec.num_actions_pad
            branch = torch.div(a, pads, rounding_mode="floor")
            idx = torch.remainder(a, pads).to(torch.float32)
            t_val = idx / (pads - 1) * (2 * mt) - mt
            y_val = idx / (pads - 1) * (2 * my) - my
            zero = torch.zeros_like(t_val)
            tx = torch.where(branch == 0, t_val, zero)
            ty = torch.where(branch == 1, t_val, zero)
            yaw = torch.where(branch == 2, y_val, zero)
        else:
            high = torch.tensor([mt, mt, my], dtype=torch.float32, device=action.device)
            a = action.to(torch.float32) * high
            t2, yaw = _clip(a[:, :2], a[:, 2], mt, my)
            tx, ty = t2[:, 0], t2[:, 1]
        cmd = torch.full_like(tx, CMD_MOVE, dtype=torch.int64)
        return torch.stack([tx, ty, _descent(tx)], -1), yaw, cmd

    if spec.discrete:
        row = full_discrete_table(spec, action.device)[action.to(torch.int64).reshape(-1)]
        translation, yaw, open_close = row[:, :3], row[:, 3], row[:, 4]
    else:
        high = torch.tensor([mt, mt, mt, my, 1.0], dtype=torch.float32, device=action.device)
        a = action.to(torch.float32) * high
        translation, yaw = _clip(a[:, :3], a[:, 3], mt, my)
        open_close = a[:, 4]
    cmd = torch.where(
        (open_close > 0.0) & gripper_close, CMD_OPEN,
        torch.where((open_close < 0.0) & ~gripper_close, CMD_CLOSE, CMD_MOVE))
    return translation, yaw, cmd


def decode_branched_action(spec: ActuatorSpec, bins):
    """BDQ composite actions (actuator.py:139-160): bins (B, 3) = (dx, dy,
    dyaw) on the simplified task, (B, 5) = (dx, dy, dz, dyaw, open/close)
    on the full task, each bin in [0, num_actions_pad). Bins map linearly
    onto [-max, max]; the open/close branch's middle bin is a no-op, its
    ends open and close whatever the gripper's state."""
    mt, my = spec.max_translation, spec.max_yaw_rotation
    f = bins.to(torch.float32) / (spec.num_actions_pad - 1)
    if spec.simplified:
        tx = f[:, 0] * 2 * mt - mt
        ty = f[:, 1] * 2 * mt - mt
        yaw = f[:, 2] * 2 * my - my
        cmd = torch.full_like(tx, CMD_MOVE, dtype=torch.int64)
        return torch.stack([tx, ty, _descent(tx)], -1), yaw, cmd
    t = f[:, :3] * 2 * mt - mt
    yaw = f[:, 3] * 2 * my - my
    oc = f[:, 4] * 2.0 - 1.0
    cmd = torch.where(oc > 1e-6, CMD_OPEN, torch.where(oc < -1e-6, CMD_CLOSE, CMD_MOVE))
    return t, yaw, cmd


def actuator_obs(spec: ActuatorSpec, width, height):
    """Opening-width observation (actuator.py:43-52), (B, 1) or (B, 2)."""
    if spec.include_robot_height:
        return torch.stack([width / 0.05, height], -1)
    return (width / 0.1)[:, None]
