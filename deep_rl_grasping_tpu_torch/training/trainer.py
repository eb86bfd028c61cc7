"""Evaluation harness (port of `EvalMixin.evaluate`,
deep_rl_grasping_tpu/training/trainer.py:132).

Fixed-scene protocol: `n_episodes` envs run in parallel at curriculum
lambda 1 (unless given), every scene drawn from one generator seeded with
1 (the JAX package uses PRNGKey(1); torch cannot reproduce that stream, so
the scenes differ but the protocol is the same); the step loop stops once
every env has finished its first episode or the time horizon is reached.
Training waits for a later slice.
"""

from __future__ import annotations

import torch

from deep_rl_grasping_tpu_torch.algos import normalize as norm_mod
from deep_rl_grasping_tpu_torch.algos import sac
from deep_rl_grasping_tpu_torch.envs.grasp_env import BatchedGraspEnv, GraspEnv
from deep_rl_grasping_tpu_torch.utils import config as cfg_util

SCENE_SEED = 1


class EvalMixin:
    """Needs `self.config`, `self.normalize` and `self.device`."""

    def evaluate(self, actor, normalizer, n_episodes=10, validate=True, stochastic=False,
                 lam=None, action_seed=0):
        eval_env = GraspEnv(self.config, evaluate=True, validate=validate, device=self.device)
        scene_gen = torch.Generator(device=self.device)
        scene_gen.manual_seed(SCENE_SEED)
        act_gen = torch.Generator(device=self.device)
        act_gen.manual_seed(action_seed)
        benv = BatchedGraspEnv(eval_env, n_episodes, scene_gen)
        lam_val = 1.0 if lam is None else float(lam)

        states, obs = benv.reset(lam_val)
        B, dev = n_episodes, self.device
        done_once = torch.zeros(B, dtype=torch.bool, device=dev)
        ret = torch.zeros(B, device=dev)
        length = torch.zeros(B, dtype=torch.int32, device=dev)
        succ = torch.zeros(B, dtype=torch.bool, device=dev)
        t = 0
        while t < eval_env.time_horizon and not bool(done_once.all()):
            obs_in = norm_mod.normalize_obs(normalizer, obs) if self.normalize else obs
            actions = sac.act(actor, obs_in, act_gen, deterministic=not stochastic)
            states, obs, rewards, dones, infos = benv.step(states, actions, lam_val)
            first_done = dones & ~done_once
            ret = torch.where(first_done, infos["episode_return"], ret)
            length = torch.where(first_done, infos["episode_step"], length)
            succ = torch.where(first_done, infos["is_success"], succ)
            done_once = done_once | dones
            t += 1
        n_done = max(int(done_once.sum()), 1)
        zero = torch.zeros_like(ret)
        return dict(
            mean_return=float(torch.where(done_once, ret, zero).sum()) / n_done,
            mean_length=float(torch.where(done_once, length.to(ret.dtype), zero).sum()) / n_done,
            success_rate=float((done_once & succ).sum()) / n_done,
            episodes=int(done_once.sum()),
            control_steps=t,
        )


class Evaluator(EvalMixin):
    def __init__(self, config, device="cuda"):
        self.config = cfg_util.load_config(config)
        self.normalize = bool(self.config.get("normalize", False))
        self.device = torch.device(device)
