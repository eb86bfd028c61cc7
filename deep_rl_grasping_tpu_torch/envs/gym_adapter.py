"""Single-env gym surface over the port's env (port of
deep_rl_grasping_tpu/envs/gym_adapter.py).

`GymGraspEnv` wraps `GraspEnv` and its batched step at B=1 in the
reference's mutable-env API (tests_gripper/test_sim.py and the debug path
of manipulation_main/utils.py): reset() -> obs, step(a) -> (obs, reward,
done, info), action_space, observation_space, get_pose(), close_gripper(),
open_gripper(), get_gripper_width(), object_detected(), is_simplified(),
is_discrete(), num_alive_objects and curriculum. Observations, rewards and
info values come back as numpy. For tests, debugging (tools/debug_scene.py)
and probing; training steps the batched env directly.

The env runs on `device`: through the CUDA kernels on the card (the
default), through their plain versions for the CPU. An evaluation env draws
its scenes from a generator seeded with 1, so that object sequences repeat
(reference simulation.py:91-100, RandomState(1)); others from `seed`.
Encoder-latent configs load the trained encoder of `sensor.encoder_dir`
as the trainer does, and are refused without one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from deep_rl_grasping_tpu_torch.envs import rewards as rew
from deep_rl_grasping_tpu_torch.envs.grasp_env import BatchedGraspEnv, GraspEnv
from deep_rl_grasping_tpu_torch.models.autoencoder import encoder_for_config
from deep_rl_grasping_tpu_torch.ops import solver_cuda
from deep_rl_grasping_tpu_torch.sim import physics
from deep_rl_grasping_tpu_torch.sim.types import FINGER_CLOSED, FINGER_OPEN
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import transforms


@dataclass
class BoxSpace:
    low: float
    high: float
    shape: tuple

    def sample(self, rng=np.random):
        return rng.uniform(self.low, self.high, self.shape).astype(np.float32)

    @property
    def dtype(self):
        return np.float32


@dataclass
class DiscreteSpace:
    n: int

    def sample(self, rng=np.random):
        return int(rng.randint(self.n)) if hasattr(rng, "randint") else int(rng.integers(self.n))

    @property
    def shape(self):
        return ()


class GymGraspEnv:
    Status = rew

    def __init__(self, config, evaluate=False, test=False, validate=False, seed=0,
                 device="cuda"):
        config = cfg_util.load_config(config)
        self.device = torch.device(device)
        self.env = GraspEnv(config, evaluate=evaluate, test=test, validate=validate,
                            device=self.device, encoder=encoder_for_config(config, self.device))
        gen = torch.Generator(device=self.device).manual_seed(1 if evaluate else seed)
        self._benv = BatchedGraspEnv(self.env, 1, gen)
        self._curr = self._benv.init_curriculum()
        self._state = None
        if self.env.discrete:
            self.action_space = DiscreteSpace(self.env.num_actions)
        else:
            self.action_space = BoxSpace(-1.0, 1.0, (self.env.action_dim,))
        if self.env.depth_obs or self.env.full_obs:
            self.observation_space = BoxSpace(0.0, 255.0, tuple(self.env.obs_shape))
        else:
            self.observation_space = BoxSpace(-1.0, 1.0, tuple(self.env.obs_shape))

    # -- gym API ------------------------------------------------------------

    def reset(self):
        self._state, obs = self._benv.reset(self._curr)
        return obs[0].cpu().numpy()

    def step(self, action):
        if self.env.discrete:
            a = torch.tensor([int(action)], dtype=torch.int32, device=self.device)
        else:
            a = torch.as_tensor(np.asarray(action, np.float32), device=self.device)[None]
        self._state, obs, reward, done, info, curriculum = self._benv.step(self._state, a,
                                                                          self._curr)
        done = bool(done[0])
        if done:  # the window takes finished episodes only
            self._curr = curriculum
        return (obs[0].cpu().numpy(), float(reward[0]), done,
                {k: v[0].cpu().numpy() for k, v in info.items()})

    def close(self):
        pass

    # -- reference task API (robot.py:264-306) ------------------------------

    @property
    def depth_obs(self):
        return self.env.depth_obs

    @property
    def full_obs(self):
        return self.env.full_obs

    def is_simplified(self):
        return self.env.simplified

    def is_discrete(self):
        return self.env.discrete

    def get_pose(self):
        """Gripper position and orientation [x, y, z, w] (its yaw, pointing
        down), as numpy."""
        q = self._state.sim.gripper.q[0].cpu()
        quat = transforms.quat_mul(transforms.quat_from_euler(0.0, 0.0, q[3]),
                                   transforms.quat_from_euler(math.pi, 0.0, 0.0))
        return q[:3].numpy(), quat.numpy()

    def get_gripper_width(self):
        return float(physics.gripper_width(self._state.sim.gripper.q[0]))

    def object_detected(self, tol=0.005):
        return bool(self.env.object_detected(self._state.sim, tol)[0])

    def close_gripper(self):
        self._set_fingers(FINGER_CLOSED, close=True)

    def open_gripper(self):
        self._set_fingers(FINGER_OPEN, close=False)

    def _set_fingers(self, target, close):
        sim = self._state.sim
        g = sim.gripper.replace(finger_target=torch.full_like(sim.gripper.finger_target, target),
                                gripper_close=torch.full_like(sim.gripper.gripper_close, close))
        sim = solver_cuda.run_batched_sim(sim.replace(gripper=g), self.env.sim_params,
                                          self.env.gripper_substeps)
        self._state = self._state.replace(sim=sim)

    @property
    def num_alive_objects(self):
        return int(self._state.sim.objects.alive.sum())

    @property
    def curriculum(self):
        return self._curr
