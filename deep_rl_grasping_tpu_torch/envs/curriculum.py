"""Workspace curriculum (port of deep_rl_grasping_tpu/envs/curriculum.py).

Lambda in [0,1] interpolates extent / spawn height / object counts / lift
distance; evaluation forces lambda = 1 (curriculum.py:33). Here lambda is
a Python float held by the caller.
"""

from __future__ import annotations

from dataclasses import dataclass


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
