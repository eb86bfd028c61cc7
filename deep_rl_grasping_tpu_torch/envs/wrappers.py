"""Observation wrappers (port of `append_time_feature` in
deep_rl_grasping_tpu/envs/wrappers.py :16-21).

TimeFeatureWrapper (arXiv:1712.00378) as a function of the batched env
state: the remaining-time fraction 1 - t/T appended to flat (latent)
observations. Image observations never carry it. The gym-side
`TimeFeatureGymWrapper` is not ported yet.
"""

from __future__ import annotations

import torch


def append_time_feature(obs, episode_step, max_steps):
    """obs (..., D) + remaining-time feature -> (..., D+1). The JAX
    function's `test_mode` (a constant 1.0) has no caller in the env and is
    not ported."""
    t = 1.0 - episode_step.to(torch.float32) / max_steps
    return torch.cat([obs, t[..., None]], -1)
