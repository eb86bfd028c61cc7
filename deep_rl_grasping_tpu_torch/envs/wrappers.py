"""Observation wrappers (port of deep_rl_grasping_tpu/envs/wrappers.py).

TimeFeatureWrapper (arXiv:1712.00378, reference training/wrapper.py:5-54):
the remaining-time fraction 1 - t/T appended to flat observations.
`append_time_feature` does it as a function of the batched env state
(latent observations; image observations never carry it);
`TimeFeatureGymWrapper` around the gym adapter (envs/gym_adapter.py), on
numpy observations.
"""

from __future__ import annotations

import numpy as np
import torch


def append_time_feature(obs, episode_step, max_steps):
    """obs (..., D) + remaining-time feature -> (..., D+1). The JAX
    function's `test_mode` (a constant 1.0) has no caller in the env and is
    not ported."""
    t = 1.0 - episode_step.to(torch.float32) / max_steps
    return torch.cat([obs, t[..., None]], -1)


class TimeFeatureGymWrapper:
    """The gym adapter's observation flattened, with 1 - t/T appended (1.0
    in `test_mode`); T defaults to the env's time horizon. Other
    attributes pass through to the wrapped env."""

    def __init__(self, env, max_steps=None, test_mode=False):
        self.env = env
        self._max_steps = max_steps or env.env.time_horizon
        self._test_mode = test_mode
        self._t = 0
        space = env.observation_space
        low = np.append(np.broadcast_to(space.low, space.shape).reshape(-1), 0.0)
        self.observation_space = type(space)(low=float(low.min()), high=1.0,
                                             shape=(int(np.prod(space.shape)) + 1,))
        self.action_space = env.action_space

    def _augment(self, obs):
        feat = 1.0 if self._test_mode else 1.0 - self._t / self._max_steps
        return np.append(np.asarray(obs).reshape(-1), np.float32(feat))

    def reset(self):
        self._t = 0
        return self._augment(self.env.reset())

    def step(self, action):
        self._t += 1
        obs, r, d, info = self.env.step(action)
        return self._augment(obs), r, d, info

    def __getattr__(self, name):
        return getattr(self.env, name)
