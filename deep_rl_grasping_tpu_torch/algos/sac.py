"""SAC acting (port of `SAC.act`, deep_rl_grasping_tpu/algos/sac.py:156).

Only the policy's action is ported in this slice; the critic, replay and
the SAC update wait for the training slice.
"""

from __future__ import annotations

import torch

from deep_rl_grasping_tpu_torch.models.networks import SACActor


@torch.no_grad()
def act(actor: SACActor, obs, generator: torch.Generator = None, deterministic=False):
    """tanh(mean) when deterministic, else a squashed-Gaussian sample drawn
    with `generator`."""
    mean, log_std = actor(obs)
    if deterministic:
        return torch.tanh(mean)
    eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return torch.tanh(mean + torch.exp(log_std) * eps)
