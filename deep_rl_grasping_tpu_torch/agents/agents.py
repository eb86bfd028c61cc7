"""Scripted and random agents for the gym adapter (a copy of
deep_rl_grasping_tpu/agents/agents.py; numpy only).

`RandomAgent` mirrors the reference's agents/random_agent.py
(action_space.sample). The reference's `SliderAgent` drives PyBullet GUI
sliders; with no GUI, `ConstantAgent` is the fixed-action probe.
`ScriptedGraspAgent` is the biased policy of the reference's
scripts/collect_dataset.py:16-63: descend towards the surface with lateral
jitter, close at 0.07 m, lift.
"""

from __future__ import annotations

import numpy as np


class Agent:
    def act(self, obs, stochastic=True):
        raise NotImplementedError


class RandomAgent(Agent):
    def __init__(self, env, rng=None):
        self._space = env.action_space
        self._rng = rng or np.random.default_rng(0)

    def act(self, obs, stochastic=True):
        if hasattr(self._space, "n"):
            return int(self._rng.integers(self._space.n))
        return self._rng.uniform(-1.0, 1.0, self._space.shape).astype(np.float32)


class ConstantAgent(Agent):
    def __init__(self, action):
        self._action = action

    def act(self, obs, stochastic=True):
        return self._action


class ScriptedGraspAgent(Agent):
    """Descend 5 mm per step with lateral jitter, close the gripper near the
    surface, then lift for 20 steps (continuous 5-d actions)."""

    def __init__(self, env, rng=None, close_height=0.07, jitter=0.3):
        self.env = env
        self._rng = rng or np.random.default_rng(0)
        self._close_height = close_height
        self._jitter = jitter
        self._lift_steps = 0

    def reset(self):
        self._lift_steps = 0

    def act(self, obs, stochastic=True):
        pos, _ = self.env.get_pose()
        a = np.zeros(5, np.float32)
        if self._lift_steps > 0:
            self._lift_steps -= 1
            a[2] = -1.0  # local -z = world up
            a[4] = -1.0  # keep closed
            return a
        if pos[2] > self._close_height:
            a[:2] = self._rng.uniform(-self._jitter, self._jitter, 2)
            a[2] = 0.5  # local +z = descend
            a[4] = 1.0  # keep open
            return a
        self._lift_steps = 20
        a[4] = -1.0  # close
        return a
