"""Observation normalization (port of the acting part of
deep_rl_grasping_tpu/algos/normalize.py; stable-baselines VecNormalize:
running moments, clip 10). The moment updates wait for the training slice."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deep_rl_grasping_tpu_torch.sim.types import _Replace

CLIP_OBS = 10.0
EPS = 1e-8


@dataclass
class RunningMeanStd(_Replace):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def init(cls, shape, device="cpu"):
        return cls(mean=torch.zeros(shape, device=device), var=torch.ones(shape, device=device),
                   count=torch.tensor(1e-4, device=device))


@dataclass
class NormalizerState(_Replace):
    obs_rms: RunningMeanStd
    ret_rms: RunningMeanStd
    returns: torch.Tensor  # (B,) running discounted return per env

    @classmethod
    def init(cls, obs_shape, num_envs, device="cpu"):
        return cls(obs_rms=RunningMeanStd.init(obs_shape, device),
                   ret_rms=RunningMeanStd.init((), device),
                   returns=torch.zeros(num_envs, device=device))


def normalize_obs(state: NormalizerState, obs):
    z = (obs - state.obs_rms.mean) / torch.sqrt(state.obs_rms.var + EPS)
    return torch.clamp(z, -CLIP_OBS, CLIP_OBS)

