"""Training loop and evaluation harness (port of
deep_rl_grasping_tpu/training/trainer.py: `EvalMixin.evaluate` :132,
`Trainer` :225, `init_state` :333, `seed_demos` :375, `train_step` :484,
`train_chunk` :638), single device, off-policy SAC.

One training iteration steps `num_envs` envs once with the current policy,
stores the frames, and runs `updates_per_step` SAC updates on batches drawn
from the replay (with a protected demonstration ring for the batch tail
when `tpu.demo_fraction` > 0). PyTorch runs it eagerly: the env step goes
through the CUDA kernels on the card, the update through cuDNN/cuBLAS and
autograd. Differences from the JAX package, outcome unchanged:

* The learner (`SAC`, its modules and optimizers) lives in the trainer,
  not in the loop state.
* While the replay is below `learning_starts` the update is skipped, where
  the JAX package computes it and throws it away; the metrics of such an
  iteration are NaN.

Evaluation scenes use a generator seeded with 1 (the JAX package uses
PRNGKey(1); torch cannot reproduce that stream, so the scenes differ but the
protocol is the same). The prioritized replay branch is not ported yet.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import torch

from deep_rl_grasping_tpu_torch.algos import normalize as norm_mod
from deep_rl_grasping_tpu_torch.algos import replay as replay_mod
from deep_rl_grasping_tpu_torch.algos import sac
from deep_rl_grasping_tpu_torch.envs import curriculum as curr_mod
from deep_rl_grasping_tpu_torch.envs import scripted
from deep_rl_grasping_tpu_torch.envs.grasp_env import BatchedGraspEnv, EnvState, GraspEnv
from deep_rl_grasping_tpu_torch.sim.types import _Replace
from deep_rl_grasping_tpu_torch.utils import config as cfg_util

SCENE_SEED = 1
# Per-episode (return, length, success) ring, drained by the host after
# every chunk into one monitor row per episode.
MONITOR_RING = 4096
# Floor of the lambda cap on the target-entropy anneal (the JAX package's
# tpu.entropy_anneal_floor default; no config sets it).
ENTROPY_ANNEAL_FLOOR = 0.5
METRIC_KEYS = ("critic_loss", "actor_loss", "bc_loss", "bc_gate", "alpha_loss", "alpha",
               "entropy", "td_abs", "q_target_mean", "reward_mean", "reward_max", "done_frac")


class EvalMixin:
    """Needs `self.config`, `self.normalize` and `self.device`."""

    def evaluate(self, actor, normalizer, n_episodes=10, validate=True, stochastic=False,
                 lam=None):
        """Protocol evaluation: `n_episodes` envs in parallel, each until its
        first episode ends or the time horizon, at curriculum lambda `lam`
        (default 1, the protocol difficulty; the training lambda gives the
        diagnostic on the distribution the policy trains on)."""
        eval_env = GraspEnv(self.config, evaluate=True, validate=validate, device=self.device)
        scene_gen = torch.Generator(device=self.device)
        scene_gen.manual_seed(SCENE_SEED)
        act_gen = torch.Generator(device=self.device)
        act_gen.manual_seed(0)
        benv = BatchedGraspEnv(eval_env, n_episodes, scene_gen)
        lam_val = 1.0 if lam is None else float(lam)
        cur = benv.init_curriculum()
        cur = cur.replace(lam=torch.full_like(cur.lam, lam_val))

        states, obs = benv.reset(cur)
        B, dev = n_episodes, self.device
        done_once = torch.zeros(B, dtype=torch.bool, device=dev)
        ret = torch.zeros(B, device=dev)
        length = torch.zeros(B, dtype=torch.int32, device=dev)
        succ = torch.zeros(B, dtype=torch.bool, device=dev)
        t = 0
        while t < eval_env.time_horizon and not bool(done_once.all()):
            obs_in = norm_mod.normalize_obs(normalizer, obs) if self.normalize else obs
            actions = sac.act(actor, obs_in, act_gen, deterministic=not stochastic)
            states, obs, rewards, dones, infos, cur = benv.step(states, actions, cur)
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


@dataclass
class LoopState(_Replace):
    env_states: EnvState
    obs: torch.Tensor
    curriculum: curr_mod.CurriculumState
    buffer: replay_mod.ReplayBuffer
    normalizer: norm_mod.NormalizerState
    global_step: int               # env frames collected
    ep_ring: torch.Tensor          # (MONITOR_RING, 3) per-episode (return, length, success)
    ep_ring_n: torch.Tensor        # () int64 episodes ever written
    demo_buffer: replay_mod.ReplayBuffer = None


class _Clock:
    """Wall time of the env-step and update phases of each iteration: CUDA
    events on the card, the host clock on the CPU. `train_chunk` folds the
    finished intervals into running totals at the end of every chunk, so
    only one chunk's events are alive at a time."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.pending = []
        self.sums = {"env": [0.0, 0], "update": [0.0, 0]}

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def add(self, phase, start, end):
        self.pending.append((phase, start, end))

    def fold(self):
        """Add the pending intervals to the totals (waits for the last event)."""
        if self.cuda and self.pending:
            self.pending[-1][2].synchronize()
        for phase, a, b in self.pending:
            self.sums[phase][0] += a.elapsed_time(b) / 1e3 if self.cuda else b - a
            self.sums[phase][1] += 1
        self.pending = []

    def totals(self):
        """Seconds per phase and the number of intervals."""
        self.fold()
        return {k: tuple(v) for k, v in self.sums.items()}


class Trainer(EvalMixin):
    def __init__(self, config, algo="SAC", device="cuda", seed=0):
        self.config = cfg_util.load_config(config)
        self.algo_name = algo.upper()
        if self.algo_name != "SAC":
            raise NotImplementedError("the port trains SAC only")
        self.device = torch.device(device)
        tpu_cfg = self.config["tpu"]
        self.env = GraspEnv(self.config, device=self.device)
        self.num_envs = int(tpu_cfg.get("num_envs", 128))
        gen = lambda k: torch.Generator(device=self.device).manual_seed(seed * 4 + k)
        self.env_gen, self.learn_gen, self.demo_gen = gen(0), gen(1), gen(2)
        self.benv = BatchedGraspEnv(self.env, self.num_envs, self.env_gen)
        self.updates_per_step = int(tpu_cfg.get("updates_per_step", 1))
        self.algo = sac.SAC(self.env.obs_shape, self.env.action_dim, self.config, self.device)
        self.normalize = bool(self.config.get("normalize", False))
        # fixed learner-side reward scale; overrides reward normalization
        self.reward_scale = float(self.config.get("reward_scale", 0) or 0)
        algo_cfg = self.config.get("SAC", {})
        self.buffer_size = int(algo_cfg.get("buffer_size", 200_000))
        self.batch_size = int(algo_cfg.get("batch_size", 256))
        self.learning_starts = int(algo_cfg.get("learning_starts", 1000))
        self.n_step = int(algo_cfg.get("n_step", 1))
        self.demo_fraction = float(tpu_cfg.get("demo_fraction", 0) or 0)
        self.demo_batch = int(round(self.batch_size * self.demo_fraction))
        self.recent_fraction = float(tpu_cfg.get("recent_fraction", 0) or 0)
        self.recent_window = int(tpu_cfg.get("recent_window", 0) or 0)
        self.entropy_anneal_lambda = bool(tpu_cfg.get("entropy_anneal_lambda"))
        if self.demo_batch > 0 and not int(tpu_cfg.get("demo_frames", 0)):
            raise ValueError("tpu.demo_fraction > 0 requires tpu.demo_frames > 0 "
                             "(the demo ring is filled by scripted-expert seeding)")
        self.demo_capacity = int(tpu_cfg.get("demo_capacity", tpu_cfg.get("demo_frames", 0)))
        self.act_shape = (self.env.action_dim,)
        self.clock = _Clock(self.device)

    # ------------------------------------------------------------------ init

    def init_state(self) -> LoopState:
        dev = self.device
        curriculum = self.benv.init_curriculum()
        env_states, obs = self.benv.reset(curriculum)
        make = lambda cap: replay_mod.create(cap, self.env.obs_shape, self.act_shape,
                                             batch_stride=self.num_envs, device=dev)
        return LoopState(
            env_states=env_states, obs=obs, curriculum=curriculum,
            buffer=make(self.buffer_size),
            normalizer=norm_mod.NormalizerState.init(self.env.obs_shape, self.num_envs, dev),
            global_step=0,
            ep_ring=torch.zeros((MONITOR_RING, 3), device=dev),
            ep_ring_n=torch.zeros((), dtype=torch.int64, device=dev),
            demo_buffer=make(self.demo_capacity) if self.demo_batch > 0 else None,
        )

    # ------------------------------------------------------------------ demos

    def seed_demos(self, state: LoopState, n_frames: int):
        """Fill the replay (and the protected demo ring) with scripted-expert
        transitions at the current curriculum lambda. The normalizer folds
        them in; the curriculum window does not (demo successes must not
        advance lambda). Returns (state, episodes ended, successes)."""
        env_states, obs, normalizer = state.env_states, state.obs, state.normalizer
        n_done = torch.zeros((), device=self.device)
        n_succ = torch.zeros((), device=self.device)
        for _ in range(max(n_frames // self.num_envs, 1)):
            actions = scripted.scripted_full_action(self.env, env_states, self.demo_gen)
            env_states, next_obs, rewards, dones, infos, _cur = self.benv.step(
                env_states, actions, state.curriculum)
            normalizer = norm_mod.update_batch(normalizer, obs, rewards, dones,
                                               gamma=self.algo.gamma, training=self.normalize)
            replay_mod.insert(state.buffer, obs, actions, rewards, dones)
            if state.demo_buffer is not None:
                replay_mod.insert(state.demo_buffer, obs, actions, rewards, dones)
            n_done += dones.sum()
            n_succ += (dones & infos["is_success"]).sum()
            obs = next_obs
        return (state.replace(env_states=env_states, obs=obs, normalizer=normalizer),
                float(n_done), float(n_succ))

    # ------------------------------------------------------------------ core

    def _target_entropy_at(self, frames, lam=None):
        """Annealed SAC target entropy at `frames` env frames, the anneal
        fraction capped by floor + (1 - floor) * lambda with
        tpu.entropy_anneal_lambda (trainer.py:457); None when no anneal is
        configured."""
        a = self.algo
        if a.target_entropy_final is None or a.target_entropy_anneal <= 0:
            return None
        frac = min(max(frames / a.target_entropy_anneal, 0.0), 1.0)
        if self.entropy_anneal_lambda and lam is not None:
            f = ENTROPY_ANNEAL_FLOOR
            frac = min(frac, f + (1.0 - f) * lam)
        return a.target_entropy + frac * (float(a.target_entropy_final) - a.target_entropy)

    def _scale_batch_reward(self, batch, normalizer):
        if self.reward_scale:
            batch["reward"] = batch["reward"] * self.reward_scale
        elif self.normalize:
            batch["reward"] = norm_mod.normalize_reward(normalizer, batch["reward"])
        return batch

    def _batch(self, state: LoopState, normalizer):
        """One update batch: uniform (with recency stratification) from the
        main ring, plus the demo tail when demo oversampling is on."""
        gen, gamma = self.learn_gen, self.algo.gamma
        if self.demo_batch > 0:
            n_main = self.batch_size - self.demo_batch
            main = replay_mod.sample(state.buffer, gen, n_main, self.n_step, gamma,
                                     recent_batch=int(round(n_main * self.recent_fraction)),
                                     recent_window=self.recent_window)
            demo = replay_mod.sample(state.demo_buffer, gen, self.demo_batch, self.n_step, gamma)
            batch = {k: torch.cat([main[k], demo[k]], 0) for k in main}
            is_demo = torch.arange(self.batch_size, device=self.device) >= n_main
            # an unseeded demo ring's zero frames must not train anything
            if state.demo_buffer.size < (self.n_step + 1) * state.demo_buffer.batch_stride:
                batch["weight"] = torch.where(is_demo, 0.0, batch["weight"])
                is_demo = torch.zeros_like(is_demo)
            batch["is_demo"] = is_demo
        else:
            batch = replay_mod.sample(
                state.buffer, gen, self.batch_size, self.n_step, gamma,
                recent_batch=int(round(self.batch_size * self.recent_fraction)),
                recent_window=self.recent_window)
        if self.normalize:
            batch["obs"] = norm_mod.normalize_obs(normalizer, batch["obs"])
            batch["next_obs"] = norm_mod.normalize_obs(normalizer, batch["next_obs"])
        return self._scale_batch_reward(batch, normalizer)

    def train_step(self, state: LoopState):
        """One collect + update iteration. Returns (state, metrics of the
        last update, as tensors; NaN when no update ran)."""
        clock = self.clock
        t0 = clock.mark()
        obs_in = (norm_mod.normalize_obs(state.normalizer, state.obs) if self.normalize
                  else state.obs)
        actions = sac.act(self.algo.actor, obs_in, self.learn_gen)
        lam = float(state.curriculum.lam)
        target_entropy = self._target_entropy_at(state.global_step, lam)
        env_states, next_obs, rewards, dones, infos, curriculum = self.benv.step(
            state.env_states, actions, state.curriculum)
        normalizer = norm_mod.update_batch(state.normalizer, state.obs, rewards, dones,
                                           gamma=self.algo.gamma, training=self.normalize)
        buffer = replay_mod.insert(state.buffer, state.obs, actions, rewards, dones)
        t1 = clock.mark()
        clock.add("env", t0, t1)

        metrics = None
        if buffer.size >= max(self.learning_starts, self.batch_size + self.num_envs):
            for _ in range(self.updates_per_step):
                batch = self._batch(state, normalizer)
                metrics, _td = self.algo.update(batch, self.learn_gen,
                                                target_entropy=target_entropy)
            clock.add("update", t1, clock.mark())
        if metrics is None:
            nan = torch.tensor(math.nan, device=self.device)
            metrics = {k: nan for k in METRIC_KEYS}

        # per-episode monitor ring: keep the last MONITOR_RING of this step's
        # finished episodes (spare slot R takes the dropped ones)
        R = MONITOR_RING
        d64 = dones.to(torch.int64)
        offset = torch.cumsum(d64, 0) - d64
        n_new = d64.sum()
        pos = torch.where(dones & (offset >= n_new - R), (state.ep_ring_n + offset) % R, R)
        rows = torch.stack([infos["episode_return"], infos["episode_step"].to(torch.float32),
                            infos["is_success"].to(torch.float32)], -1)
        ring = torch.cat([state.ep_ring, state.ep_ring.new_zeros(1, 3)])
        ring.index_copy_(0, pos, rows)
        new_state = state.replace(
            env_states=env_states, obs=next_obs, curriculum=curriculum, buffer=buffer,
            normalizer=normalizer, global_step=state.global_step + self.num_envs,
            ep_ring=ring[:R], ep_ring_n=state.ep_ring_n + n_new)
        return new_state, metrics

    def train_chunk(self, state: LoopState, n_steps: int):
        """`n_steps` iterations; returns the final state and the last metrics."""
        metrics = None
        for _ in range(n_steps):
            state, metrics = self.train_step(state)
        self.clock.fold()
        return state, metrics
