"""Observation and reward normalization (port of
deep_rl_grasping_tpu/algos/normalize.py; stable-baselines VecNormalize):
running per-element moments of the observations and a running variance of
the discounted returns, folded in one env batch at a time (Chan's parallel
update), clip 10."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from deep_rl_grasping_tpu_torch.sim.types import _Replace

CLIP_OBS = 10.0
CLIP_REWARD = 10.0
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


def rms_update(rms: RunningMeanStd, batch) -> RunningMeanStd:
    """Fold a batch (leading axis = samples) into the running moments."""
    b = batch.reshape((-1,) + tuple(rms.mean.shape)).to(torch.float32)
    bc = b.shape[0]
    bm = b.mean(0)
    bv = b.var(0, unbiased=False)
    delta = bm - rms.mean
    tot = rms.count + bc
    mean = rms.mean + delta * bc / tot
    m2 = rms.var * rms.count + bv * bc + delta ** 2 * rms.count * bc / tot
    return RunningMeanStd(mean=mean, var=m2 / tot, count=tot)


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


def update_batch(state: NormalizerState, obs, reward, done, gamma=0.99, training=True):
    """Fold one env-batch step into the running statistics."""
    if not training:
        return state
    returns = state.returns * gamma * (1.0 - done.to(torch.float32)) + reward
    return NormalizerState(obs_rms=rms_update(state.obs_rms, obs),
                           ret_rms=rms_update(state.ret_rms, returns), returns=returns)


def normalize_reward(state: NormalizerState, reward):
    return torch.clamp(reward / torch.sqrt(state.ret_rms.var + EPS), -CLIP_REWARD, CLIP_REWARD)
