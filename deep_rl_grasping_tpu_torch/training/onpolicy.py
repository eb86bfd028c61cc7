"""On-policy training loop for PPO and TRPO (port of
deep_rl_grasping_tpu/training/onpolicy.py, `OnPolicyTrainer` :39-180).

One iteration (`train_iteration`, onpolicy.py:85) collects `n_steps`
control steps of the B envs with the current policy. Each step's policy
input is the observation normalized by the moments as they stand before
that step is folded in; with `normalize: true` the stored rewards are
scaled by the running return variance, as the off-policy trainer scales
its batches. Then the GAE of the (T, B) rollout, its last value taken on
the observation normalized by the moments after the rollout
(:123-128), and the update on the T * B rows: PPO `n_epochs` passes, each
over one fresh permutation cut into `n_minibatches` minibatches
(:140-163); TRPO one update on the whole rollout (:164-165). An iteration
is `n_steps * num_envs` frames (8192 for both shipped configs), and the
command line counts chunks and cadences in iterations (train.py:149-155).

The loop state is the off-policy trainer's `LoopState` with no replay: the
envs, observations, curriculum, normalizer, frame count and the
per-episode monitor ring. The JAX loop state has no monitor ring, so its
`train` command fails on PPO and TRPO at the first drain of the ring
(train.py:339); here the rollout fills it, one row per finished episode.
The learner lives in the trainer, as in training/trainer.py. Every random
draw takes an explicit `torch.Generator`.
"""

from __future__ import annotations

import torch

from deep_rl_grasping_tpu_torch.algos import normalize as norm_mod
from deep_rl_grasping_tpu_torch.algos.ppo import PPO
from deep_rl_grasping_tpu_torch.algos.trpo import TRPO
from deep_rl_grasping_tpu_torch.envs.grasp_env import BatchedGraspEnv, GraspEnv
from deep_rl_grasping_tpu_torch.training.trainer import (
    MONITOR_RING,
    EvalMixin,
    LoopState,
    _Clock,
    _maybe_load_encoder,
    record_episodes,
    refuse_unported,
)
from deep_rl_grasping_tpu_torch.utils import config as cfg_util

LEARNERS = {"PPO": PPO, "TRPO": TRPO}


class OnPolicyTrainer(EvalMixin):
    prioritized = False

    def __init__(self, config, algo="PPO", device="cuda", seed=0):
        self.config = cfg_util.load_config(config)
        self.algo_name = algo.upper()
        self.device = torch.device(device)
        refuse_unported(self.config["tpu"])
        self.encoder = _maybe_load_encoder(self.config, self.device)
        self.env = GraspEnv(self.config, device=self.device, encoder=self.encoder)
        self.num_envs = int(self.config["tpu"].get("num_envs", 128))
        gen = lambda k: torch.Generator(device=self.device).manual_seed(seed * 4 + k)
        self.env_gen, self.learn_gen = gen(0), gen(1)
        self.benv = BatchedGraspEnv(self.env, self.num_envs, self.env_gen)
        self.normalize = bool(self.config.get("normalize", False))
        self.algo = LEARNERS[self.algo_name](
            self.env.obs_shape,
            self.env.num_actions if self.env.discrete else self.env.action_dim,
            self.config, discrete=self.env.discrete, device=self.device)
        self.frames_per_iteration = self.algo.n_steps * self.num_envs
        self.clock = _Clock(self.device)
        self.rollout = None  # the last iteration's trajectory and batch

    @property
    def policy(self):
        return self.algo

    def init_state(self) -> LoopState:
        dev = self.device
        curriculum = self.benv.init_curriculum()
        env_states, obs = self.benv.reset(curriculum)
        return LoopState(
            env_states=env_states, obs=obs, curriculum=curriculum, buffer=None,
            normalizer=norm_mod.NormalizerState.init(self.env.obs_shape, self.num_envs, dev),
            global_step=0, ep_ring=torch.zeros((MONITOR_RING, 3), device=dev),
            ep_ring_n=torch.zeros((), dtype=torch.int64, device=dev))

    def _norm_obs(self, normalizer, obs):
        return norm_mod.normalize_obs(normalizer, obs) if self.normalize else obs

    def train_iteration(self, state: LoopState):
        """Collect n_steps x B frames, compute GAE, update the policy.
        Returns (state, metrics of the last update, as tensors)."""
        clock, algo, T = self.clock, self.algo, self.algo.n_steps
        t0 = clock.mark()
        keys = ("obs", "action", "logp", "value", "reward", "done")
        traj = {k: [] for k in keys}
        normalizer = state.normalizer
        for _ in range(T):
            obs_in = self._norm_obs(normalizer, state.obs)
            action, logp, value = algo.act(obs_in, self.learn_gen)
            env_states, next_obs, reward, done, info, cur = self.benv.step(
                state.env_states, action, state.curriculum)
            normalizer = norm_mod.update_batch(normalizer, state.obs, reward, done,
                                               gamma=algo.gamma, training=self.normalize)
            if self.normalize:
                reward = norm_mod.normalize_reward(normalizer, reward)
            for k, v in zip(keys, (obs_in, action, logp, value, reward, done)):
                traj[k].append(v)
            state = record_episodes(state, done, info).replace(
                env_states=env_states, obs=next_obs, curriculum=cur,
                global_step=state.global_step + self.num_envs)
        state = state.replace(normalizer=normalizer)
        t1 = clock.mark()
        clock.add("env", t0, t1)

        traj = {k: torch.stack(v) for k, v in traj.items()}
        last_value = algo.value(self._norm_obs(normalizer, state.obs))
        adv, ret = algo.gae(traj["reward"], traj["value"], traj["done"], last_value)
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
        batch = {"obs": flat(traj["obs"]), "action": flat(traj["action"]),
                 "logp": flat(traj["logp"]), "value": flat(traj["value"]),
                 "advantage": flat(adv), "return": flat(ret)}
        self.rollout = dict(traj=traj, last_value=last_value, batch=batch)
        if self.algo_name == "PPO":
            n = batch["obs"].shape[0]
            mb = n // algo.n_minibatches
            for _ in range(algo.n_epochs):
                perm = torch.randperm(n, generator=self.learn_gen, device=self.device)
                for i in range(algo.n_minibatches):
                    idx = perm[i * mb:(i + 1) * mb]
                    metrics = algo.update({k: v[idx] for k, v in batch.items()})
        else:
            metrics = algo.update(batch)
        clock.add("update", t1, clock.mark())
        return state, metrics

    def train_chunk(self, state: LoopState, n_iterations: int):
        """`n_iterations` policy iterations; returns the final state and the
        last metrics."""
        metrics = None
        for _ in range(n_iterations):
            state, metrics = self.train_iteration(state)
        self.clock.fold()
        return state, metrics
