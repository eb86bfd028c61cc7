"""Workspace curriculum (port of deep_rl_grasping_tpu/envs/curriculum.py).

Lambda in [0,1] interpolates extent / spawn height / object counts / lift
distance; evaluation forces lambda = 1 (curriculum.py:33). `params_at`
takes lambda as a Python float. `CurriculumState` is the sliding window of
the last `window_size` episode outcomes, held in tensors on the env's
device; `update` folds a batch of finished episodes into it with the JAX
package's exact deque semantics (curriculum.py:110).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deep_rl_grasping_tpu_torch.sim.types import _Replace


def _convert(lam, rng):
    return rng[0] + (rng[1] - rng[0]) * lam


@dataclass(frozen=True)
class CurriculumSpec:
    n_steps: int
    success_threshold: float
    window_size: int
    init_lambda: float
    extent: tuple
    robot_height: tuple
    max_objects: tuple
    min_objects: tuple
    lift_dist: tuple

    @classmethod
    def from_config(cls, config):
        c = config["curriculum"]
        return cls(
            n_steps=int(c["n_steps"]),
            success_threshold=float(c["success_threshold"]),
            window_size=int(c["window_size"]),
            init_lambda=float(c.get("init_lambda", 0.0)),
            extent=tuple(c["extent"]),
            robot_height=tuple(c["robot_height"]),
            max_objects=tuple(c["max_objects"]),
            min_objects=tuple(c.get("min_objects", [1, 1])),
            lift_dist=tuple(c["lift_dist"]) if c.get("lift_dist") else None,
        )


def params_at(spec: CurriculumSpec, lam: float):
    """Task parameters at difficulty lambda (curriculum.py:57-78), including
    the reference quirk that min_objects comes from the max_objects range."""
    n = int(round(_convert(lam, spec.max_objects)))
    return dict(
        extent=float(_convert(lam, spec.extent)),
        robot_height=float(_convert(lam, spec.robot_height)),
        max_objects=n,
        min_objects=n,
        lift_dist=float(_convert(lam, spec.lift_dist)) if spec.lift_dist is not None else 0.1,
    )


@dataclass
class CurriculumState(_Replace):
    lam: torch.Tensor               # () float32
    ring: torch.Tensor              # (window_size,) float32 episode outcomes
    ptr: torch.Tensor               # () int32 next ring slot
    filled: torch.Tensor            # () int32 episodes in the window (<= W)
    sr_mean: torch.Tensor           # () rolling success rate (for logging)
    policy_iteration: torch.Tensor  # () int32, lambda increments so far

    @classmethod
    def init(cls, spec: CurriculumSpec, evaluate=False, device="cpu"):
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
        return cls(
            lam=torch.tensor(1.0 if evaluate else spec.init_lambda, dtype=torch.float32,
                             device=device),
            ring=torch.zeros(spec.window_size, device=device),
            ptr=i32(0), filled=i32(0),
            sr_mean=torch.tensor(0.0, device=device),
            policy_iteration=i32(1),
        )


def update(spec: CurriculumSpec, state: CurriculumState, done_mask, success_mask):
    """Scatter a batch of finished episodes into the window ring and advance
    lambda by 1/n_steps when the full window clears the threshold (then the
    window empties). When more episodes finish than the window holds, only
    the last `window_size` of them are kept, in batch order."""
    W = spec.window_size
    done = done_mask.reshape(-1)
    succ = success_mask.reshape(-1).to(torch.float32)
    d32 = done.to(torch.int32)
    offset = torch.cumsum(d32, 0) - d32
    n_new = d32.sum()
    pos = (state.ptr + offset) % W
    keep = done & (offset >= n_new - W)
    # dropped lanes write to a spare slot W, cut off afterwards
    ring = torch.cat([state.ring, state.ring.new_zeros(1)])
    ring.scatter_(0, torch.where(keep, pos, W).long(), succ)
    ring = ring[:W]
    ptr = (state.ptr + n_new) % W
    filled = torch.clamp(state.filled + n_new, max=W)
    rate = ring.sum() / torch.clamp(filled, min=1).to(torch.float32)
    advance = (filled >= W) & (rate > spec.success_threshold) & (state.lam < 1.0)
    lam = torch.where(advance, torch.clamp(state.lam + 1.0 / spec.n_steps, max=1.0), state.lam)
    zero = torch.zeros_like(ptr)
    return state.replace(
        lam=lam.to(torch.float32),
        ring=torch.where(advance, torch.zeros_like(ring), ring),
        ptr=torch.where(advance, zero, ptr).to(torch.int32),
        filled=torch.where(advance, zero, filled).to(torch.int32),
        sr_mean=rate,
        policy_iteration=(state.policy_iteration + advance.to(torch.int32)).to(torch.int32),
    )
