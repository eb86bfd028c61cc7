"""Rewards, batched over the env axis (port of
deep_rl_grasping_tpu/envs/rewards.py without table clearing):
`shaped_reward` for the full task (rewards.py:25-52 / 99-143), and the
simplified task's `simplified_descend` and `simplified_outcome`
(rewards.py:153-168; its close-and-lift grasp attempt is physics, run by
the env step).

Status codes follow RobotEnv.Status (robot.py:40-44).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deep_rl_grasping_tpu_torch.sim.types import _Replace

RUNNING = 0
SUCCESS = 1
FAIL = 2
TIME_LIMIT = 3


@dataclass(frozen=True)
class RewardSpec:
    custom: bool
    shaped: bool
    terminal_reward: float
    grasp_reward: float
    delta_z_scale: float
    time_penalty: float
    table_clearing: bool
    lift_success: float
    stalled: bool
    max_delta_z: float

    @classmethod
    def from_config(cls, config):
        r = config["reward"]
        terminal = float(r.get("terminal_reward", 10000.0) or 10000.0)
        return cls(
            custom=bool(r.get("custom", False)),
            shaped=bool(r.get("shaped", True)),
            terminal_reward=terminal,
            grasp_reward=float(r.get("grasp_reward", 100.0) or 100.0),
            delta_z_scale=float(r.get("delta_z_scale", 1000.0) or 1000.0),
            time_penalty=float(r.get("time_penalty", 200.0) or 200.0),
            table_clearing=bool(r.get("table_clearing", False)),
            lift_success=float(r.get("lift_success") or terminal),
            stalled=bool(r.get("stalled", True)),
            max_delta_z=float(config["robot"]["max_translation"]),
        )


@dataclass
class RewardState(_Replace):
    lifting: torch.Tensor       # (B,) bool
    start_height: torch.Tensor  # (B,)
    old_height: torch.Tensor    # (B,)

    @classmethod
    def init(cls, robot_height, num_envs, device):
        h = torch.full((num_envs,), float(robot_height), device=device)
        return cls(lifting=torch.zeros(num_envs, dtype=torch.bool, device=device),
                   start_height=h, old_height=h.clone())


def shaped_reward(spec: RewardSpec, rs: RewardState, robot_height, detected, lift_dist):
    """Returns (reward, status, new RewardState) for a batch of envs."""
    start_h = torch.where(rs.lifting, rs.start_height, robot_height)
    lifted = detected & (robot_height - start_h > lift_dist)
    delta_z = robot_height - rs.old_height
    intermediate = torch.where(
        detected & spec.shaped, spec.grasp_reward + spec.delta_z_scale * delta_z,
        torch.zeros_like(delta_z))
    if spec.custom:
        penalty = spec.time_penalty if spec.shaped else 0.01
    else:
        penalty = (spec.grasp_reward + spec.delta_z_scale * spec.max_delta_z
                   if spec.shaped else 0.01)
    running_reward = intermediate - penalty
    terminal = 1.0 if (spec.custom and not spec.shaped) else spec.terminal_reward
    reward = torch.where(lifted, torch.full_like(running_reward, terminal), running_reward)
    status = torch.where(lifted, SUCCESS, RUNNING).to(torch.int32)
    new_rs = RewardState(lifting=detected, start_height=start_h, old_height=robot_height)
    return reward, status, new_rs


def simplified_descend(spec: RewardSpec, rs: RewardState, robot_height):
    """The simplified task's movement phase (rewards.py:153-160): FAIL when
    the descent stalls (under 2 mm of progress, with `stalled`), else
    RUNNING; reward 0. Returns (reward, status, new RewardState)."""
    stalled = (rs.old_height - robot_height < 0.002) & spec.stalled
    status = torch.where(stalled, FAIL, RUNNING).to(torch.int32)
    return torch.zeros_like(robot_height), status, rs.replace(old_height=robot_height)


def simplified_outcome(detected_after_lift):
    """The grasp attempt's verdict (rewards.py:163-168): after the close and
    the lift, SUCCESS with reward 1 iff the object is still held, else FAIL
    with 0. Returns (reward, status)."""
    reward = detected_after_lift.to(torch.float32)
    status = torch.where(detected_after_lift, SUCCESS, FAIL).to(torch.int32)
    return reward, status
