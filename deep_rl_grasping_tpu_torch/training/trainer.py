"""Training loop and evaluation harness (port of
deep_rl_grasping_tpu/training/trainer.py: `EvalMixin.evaluate` :132,
`Trainer` :225, `init_state` :333, `seed_demos` :375, `train_step` :484,
`train_chunk` :638, `make_algo` :90), single device, off-policy: SAC, DQN
and BDQ.

One training iteration steps `num_envs` envs once with the current policy,
stores the frames, and runs `updates_per_step` updates on batches drawn
from the replay: uniform (with a protected demonstration ring for the batch
tail when `tpu.demo_fraction` > 0), or prioritized when the DQN or BDQ
block sets `prioritized_replay`, each update then writing its |TD| back as
the drawn rows' priorities (trainer.py:513-517, :562-568). DQN and BDQ act
epsilon-greedily with epsilon annealed over env frames, not updates
(trainer.py:443-455); evaluation is greedy. PyTorch runs it eagerly: the
env step goes through the CUDA kernels on the card, the update through
cuDNN/cuBLAS and autograd. Differences from the JAX package, outcome
unchanged:

* The learner (`SAC`, `DQN` or `BDQ`, its modules and optimizers) lives in
  the trainer, not in the loop state.
* While the replay is below `learning_starts` the update is skipped, where
  the JAX package computes it and throws it away; the metrics of such an
  iteration are NaN.

Encoder-latent observations load the trained encoder named by
`sensor.encoder_dir` (`_maybe_load_encoder`, trainer.py:68-87) and hand it
to the training env and the evaluation env alike. Where the JAX package
falls back to a downsampled-depth stand-in when the directory or its
weights are missing (grasp_env.py:298-311), the port refuses.

Evaluation scenes use a generator seeded with 1 (the JAX package uses
PRNGKey(1); torch cannot reproduce that stream, so the scenes differ but the
protocol is the same).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass

import torch

from deep_rl_grasping_tpu_torch.algos import normalize as norm_mod
from deep_rl_grasping_tpu_torch.algos import replay as replay_mod
from deep_rl_grasping_tpu_torch.algos import sac
from deep_rl_grasping_tpu_torch.algos.bdq import BDQ
from deep_rl_grasping_tpu_torch.algos.dqn import DQN, QLearner
from deep_rl_grasping_tpu_torch.envs import curriculum as curr_mod
from deep_rl_grasping_tpu_torch.envs import scripted
from deep_rl_grasping_tpu_torch.envs.grasp_env import BatchedGraspEnv, EnvState, GraspEnv
from deep_rl_grasping_tpu_torch.sim.types import _Replace
from deep_rl_grasping_tpu_torch.training.train_encoder import load_trained_encoder
from deep_rl_grasping_tpu_torch.utils import config as cfg_util

SCENE_SEED = 1
# Per-episode (return, length, success) ring, drained by the host after
# every chunk into one monitor row per episode.
MONITOR_RING = 4096
# Floor of the lambda cap on the target-entropy anneal (the JAX package's
# tpu.entropy_anneal_floor default; no config sets it).
ENTROPY_ANNEAL_FLOOR = 0.5
ALGOS = ("SAC", "DQN", "BDQ")


def refuse_unported(tpu_cfg):
    """Raise on configuration the port cannot honour yet, rather than run
    something other than what the config asks (ROADMAP Queue 1 lists
    both items)."""
    if bool(tpu_cfg.get("sharded", False)):
        raise ValueError(
            "tpu.sharded: true asks for the data-parallel trainer "
            "(deep_rl_grasping_tpu/parallel/train_dp.py), which the port does not have yet "
            "(ROADMAP Queue 1 item 8, multi-GPU); set it to false to train on one device")
    scale = int(tpu_cfg.get("update_batch_scale", 1) or 1)
    if scale > 1:
        raise ValueError(
            f"tpu.update_batch_scale: {scale} folds that many updates into one larger batch "
            "(deep_rl_grasping_tpu/training/trainer.py:237-259), which the port does not do "
            "yet (ROADMAP Queue 1 item 6); set it to 1")


def set_action_interface(env: GraspEnv, algo_name, config):
    """BDQ acts with one bin per action dimension: the env decodes branched
    actions with the BDQ block's pad count, not robot.num_actions_pad
    (trainer.py:97-109). Training and evaluation envs alike: an eval env
    left at the robot's pads puts every bin in the wrong place (the JAX
    package measured train sr 0.89, eval 0.0 that way, trainer.py:153-157)."""
    if algo_name == "BDQ":
        env.branched_actions = True
        pads = int(config.get("BDQ", {}).get("num_actions_pad", 33))
        env.actuator_spec = dataclasses.replace(env.actuator_spec, num_actions_pad=pads)
    return env


def make_algo(config, env: GraspEnv, algo_name, device):
    """The learner for `algo_name` on `env`'s observations and actions
    (trainer.py:90-113); sets BDQ's action interface on `env`."""
    algo_name = algo_name.upper()
    if algo_name == "SAC":
        return sac.SAC(env.obs_shape, env.action_dim, config, device)
    if algo_name == "DQN":
        if not env.discrete:
            raise ValueError("DQN needs a discrete action space (robot.discrete: true)")
        return DQN(env.obs_shape, env.num_actions, config, device)
    if algo_name == "BDQ":
        set_action_interface(env, algo_name, config)
        return BDQ(env.obs_shape, 3 if env.simplified else 5, config, device)
    raise NotImplementedError(f"the port trains {', '.join(ALGOS)}; not {algo_name} "
                              "(ROADMAP Queue 1 items 4-5)")


def act(policy, obs, gen, deterministic=False, frames=None):
    """Actions of a SAC actor (tanh of the mean, or a sample) or of a DQN /
    BDQ learner (greedy, or epsilon-greedy at `frames` env frames; the
    learner's update count when not given, as trainer.py:451 does)."""
    if isinstance(policy, QLearner):
        eps = 0.0 if deterministic else policy.epsilon(policy.step if frames is None else frames)
        return policy.act(obs, gen, eps)
    return sac.act(policy, obs, gen, deterministic=deterministic)


def _maybe_load_encoder(config, device):
    """The trained encoder for encoder-latent observations (the
    EncodedDepthImgSensor's weights, reference sensor.py:186-196), on
    `device`; None for image observations. Refuses when
    `sensor.encoder_dir` is unset or holds no `weights.npz`."""
    if config.get("depth_observation") or config.get("full_observation"):
        return None
    enc_dir = config.get("sensor", {}).get("encoder_dir")
    if not enc_dir:
        raise ValueError("encoder-latent observations need sensor.encoder_dir (a trained "
                         "encoder such as encoder_files/full_r4); the port has no stand-in")
    path = cfg_util.resolve_path(enc_dir)
    if not os.path.exists(os.path.join(path, "weights.npz")):
        raise ValueError(f"sensor.encoder_dir {enc_dir} ({path}) holds no weights.npz; the "
                         "port has no stand-in for a missing encoder")
    return load_trained_encoder(path, device)


class EvalMixin:
    """Needs `self.config`, `self.algo_name`, `self.normalize`, `self.device`
    and `self.encoder`."""

    def evaluate(self, actor, normalizer, n_episodes=10, validate=True, stochastic=False,
                 lam=None, initial_states=None):
        """Protocol evaluation: `n_episodes` envs in parallel, each until its
        first episode ends or the time horizon, at curriculum lambda `lam`
        (default 1, the protocol difficulty; the training lambda gives the
        diagnostic on the distribution the policy trains on).
        `initial_states` (an `EnvState` of `n_episodes` envs on the device)
        starts the protocol from given scenes instead of drawing them, for
        example the JAX package's own evaluation scenes. `actor` is a SAC
        actor or a DQN / BDQ learner (see `act`)."""
        eval_env = GraspEnv(self.config, evaluate=True, validate=validate, device=self.device,
                            encoder=self.encoder)
        set_action_interface(eval_env, self.algo_name, self.config)
        scene_gen = torch.Generator(device=self.device)
        scene_gen.manual_seed(SCENE_SEED)
        act_gen = torch.Generator(device=self.device)
        act_gen.manual_seed(0)
        benv = BatchedGraspEnv(eval_env, n_episodes, scene_gen)
        lam_val = 1.0 if lam is None else float(lam)
        cur = benv.init_curriculum()
        cur = cur.replace(lam=torch.full_like(cur.lam, lam_val))

        if initial_states is None:
            states, obs = benv.reset(cur)
        else:
            if initial_states.episode_step.shape[0] != n_episodes:
                raise ValueError(f"initial_states holds {initial_states.episode_step.shape[0]} "
                                 f"envs, expected {n_episodes}")
            states = initial_states
            obs = benv.observe_batch(states)
        B, dev = n_episodes, self.device
        done_once = torch.zeros(B, dtype=torch.bool, device=dev)
        ret = torch.zeros(B, device=dev)
        length = torch.zeros(B, dtype=torch.int32, device=dev)
        succ = torch.zeros(B, dtype=torch.bool, device=dev)
        t = 0
        while t < eval_env.time_horizon and not bool(done_once.all()):
            obs_in = norm_mod.normalize_obs(normalizer, obs) if self.normalize else obs
            actions = act(actor, obs_in, act_gen, deterministic=not stochastic)
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
        self.algo_name = str(self.config.get("algorithm", "sac")).upper()
        self.normalize = bool(self.config.get("normalize", False))
        self.device = torch.device(device)
        self.encoder = _maybe_load_encoder(self.config, self.device)


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
        self.device = torch.device(device)
        tpu_cfg = self.config["tpu"]
        refuse_unported(tpu_cfg)
        self.encoder = _maybe_load_encoder(self.config, self.device)
        self.env = GraspEnv(self.config, device=self.device, encoder=self.encoder)
        self.num_envs = int(tpu_cfg.get("num_envs", 128))
        gen = lambda k: torch.Generator(device=self.device).manual_seed(seed * 4 + k)
        self.env_gen, self.learn_gen, self.demo_gen = gen(0), gen(1), gen(2)
        self.benv = BatchedGraspEnv(self.env, self.num_envs, self.env_gen)
        self.updates_per_step = int(tpu_cfg.get("updates_per_step", 1))
        self.algo = make_algo(self.config, self.env, self.algo_name, self.device)
        self.prioritized = bool(getattr(self.algo, "prioritized", False))
        self.normalize = bool(self.config.get("normalize", False))
        # fixed learner-side reward scale; overrides reward normalization
        self.reward_scale = float(self.config.get("reward_scale", 0) or 0)
        algo_cfg = self.config.get(self.algo_name, {})
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
        # discrete actions are stored as integers (trainer.py:319-329)
        if self.algo_name == "BDQ":
            self.act_shape, self.act_dtype = (self.algo.num_branches,), torch.int32
        elif self.env.discrete:
            self.act_shape, self.act_dtype = (), torch.int32
        else:
            self.act_shape, self.act_dtype = (self.env.action_dim,), torch.float32
        self.clock = _Clock(self.device)

    @property
    def policy(self):
        """What acts: the SAC actor, or the DQN / BDQ learner (see `act`)."""
        return self.algo.actor if self.algo_name == "SAC" else self.algo

    # ------------------------------------------------------------------ init

    def init_state(self) -> LoopState:
        dev = self.device
        curriculum = self.benv.init_curriculum()
        env_states, obs = self.benv.reset(curriculum)
        make = lambda cap: replay_mod.create(cap, self.env.obs_shape, self.act_shape,
                                             batch_stride=self.num_envs,
                                             action_dtype=self.act_dtype, device=dev)
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
        advance lambda). The expert fits the action space: branched bins for
        BDQ, flat discrete actions for DQN, the simplified or the full
        continuous expert for SAC (trainer.py:388-395). Returns (state,
        episodes ended, successes)."""
        if self.algo_name == "BDQ":
            expert = scripted.scripted_branched_action
        elif self.env.discrete:
            expert = scripted.scripted_discrete_action
        elif self.env.simplified:
            expert = scripted.scripted_simplified_action
        else:
            expert = scripted.scripted_full_action
        env_states, obs, normalizer = state.env_states, state.obs, state.normalizer
        n_done = torch.zeros((), device=self.device)
        n_succ = torch.zeros((), device=self.device)
        for _ in range(max(n_frames // self.num_envs, 1)):
            actions = expert(self.env, env_states, self.demo_gen)
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
        if (self.algo_name != "SAC" or a.target_entropy_final is None
                or a.target_entropy_anneal <= 0):
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
        """One update batch: prioritized from the main ring; or uniform
        (with recency stratification) from it, plus the demo tail when demo
        oversampling is on."""
        gen, gamma = self.learn_gen, self.algo.gamma
        if self.prioritized:
            batch = replay_mod.sample_prioritized(state.buffer, gen, self.batch_size,
                                                  n_step=self.n_step, gamma=gamma)
        elif self.demo_batch > 0:
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
        actions = act(self.policy, obs_in, self.learn_gen, frames=state.global_step)
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
                if self.algo_name == "SAC":
                    metrics, td = self.algo.update(batch, self.learn_gen,
                                                   target_entropy=target_entropy)
                else:
                    metrics, td = self.algo.update(batch, self.learn_gen)
                if self.prioritized:
                    replay_mod.update_priorities(buffer, batch["idx"], td)
            clock.add("update", t1, clock.mark())
        if metrics is None:
            nan = torch.tensor(math.nan, device=self.device)
            metrics = {k: nan for k in self.algo.METRIC_KEYS}

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
