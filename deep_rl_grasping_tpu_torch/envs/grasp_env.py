"""The full continuous grasping task, batched (port of
deep_rl_grasping_tpu/envs/grasp_env.py).

`GraspEnv` holds the static task configuration and the per-env glue
(action decode, servo targets, reward, time limit, auto-reset, observation
assembly), all written over a leading env axis. `BatchedGraspEnv.step` is
the kernel-routed step of grasp_env.py:582-642 for the full task: one
solver call for `gripper_substeps` (ops/solver_cuda.py) and one render
(ops/raster_cuda.py: depth + seg, or with the shade for RGB-D
observations), then the curriculum window update. On CUDA tensors both go
through the CUDA kernels; on CPU tensors through their plain versions.
Training envs draw a randomized camera per episode (grasp_env.py:198-222).

Not ported yet: the simplified task's three-call step (:592-606), encoder
observations, table clearing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from deep_rl_grasping_tpu_torch.envs import actuator as act
from deep_rl_grasping_tpu_torch.envs import curriculum as curr
from deep_rl_grasping_tpu_torch.envs import rewards as rew
from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda
from deep_rl_grasping_tpu_torch.render import raycast
from deep_rl_grasping_tpu_torch.sim import objects as objlib
from deep_rl_grasping_tpu_torch.sim import physics, scene
from deep_rl_grasping_tpu_torch.sim.types import (
    FINGER_CLOSED,
    FINGER_OPEN,
    SimState,
    _Replace,
    make_sim_params,
    tree_where,
)
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils, transforms


@dataclass
class EnvState(_Replace):
    sim: SimState
    episode_step: torch.Tensor    # (B,) int32
    episode_return: torch.Tensor  # (B,)
    status: torch.Tensor          # (B,) int32
    reward_state: rew.RewardState
    cam_t: torch.Tensor           # (B,3) robot->camera translation
    cam_R: torch.Tensor           # (B,3,3) robot->camera rotation
    intrinsics: torch.Tensor      # (B,4) fx, fy, cx, cy
    lift_dist: torch.Tensor       # (B,)


class GraspEnv:
    """Static task configuration + batched transition functions."""

    def __init__(self, config, evaluate=False, test=False, validate=False, device="cuda"):
        config = cfg_util.load_config(config)
        self.config = config
        self.evaluate = evaluate
        self.device = torch.device(device)
        tpu = config["tpu"]
        self.simplified = bool(config["simplified"])
        self.depth_obs = bool(config.get("depth_observation", False))
        self.full_obs = bool(config.get("full_observation", False))
        if self.simplified or not (self.depth_obs or self.full_obs):
            raise NotImplementedError(
                "the port runs the full task with depth or RGB-D observations only")
        self.time_horizon = int(config["time_horizon"])
        self.actuator_spec = act.ActuatorSpec.from_config(config)
        self.reward_spec = rew.RewardSpec.from_config(config)
        if self.reward_spec.table_clearing:
            raise NotImplementedError("table clearing is not ported yet")
        self.curriculum_spec = curr.CurriculumSpec.from_config(config)

        scene_cfg = config["scene"]
        self.scene_type = scene_cfg.get("scene_type", "OnTable")
        self.max_slots = int(tpu["max_objects"])
        lib = objlib.get_library(int(tpu["spheres_per_object"]),
                                 oo_spheres=int(tpu.get("oo_spheres", 4)))
        self.sim_params = make_sim_params(
            lib, scene_type=self.scene_type, device=self.device,
            solver_iterations=int(tpu.get("solver_iterations", 8)),
            pad_inner_iterations=int(tpu.get("pad_inner_iterations", 14)),
            dt=float(tpu.get("dt", 1.0 / 240.0)),
            oo_point_mass_tangent=bool(tpu.get("oo_point_mass_tangent", False)),
            oo_pass_stride=int(tpu.get("oo_pass_stride", 1)),
            rolling_damping=float(tpu.get("rolling_damping", 0.1)),
            pinch_damping=float(tpu.get("pinch_damping", 0.0)),
        )
        if scene_cfg.get("data_set", "random_urdfs") == "wooden_blocks":
            ids = lib.wooden_block_ids()
        else:
            ids = lib.random_urdf_ids(test=test, validate=validate)
        self.type_ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)

        sensor_cfg = config["sensor"]
        cam_info = io_utils.load_yaml(cfg_util.resolve_path(sensor_cfg["camera_info"]))
        trans = io_utils.load_yaml(cfg_util.resolve_path(sensor_cfg["transform"]))
        K = np.reshape(np.asarray(cam_info["K"], np.float32), (3, 3))
        self.base_intrinsics = torch.tensor(
            [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], dtype=torch.float32, device=self.device)
        self.im_h = int(cam_info["height"])
        self.im_w = int(cam_info["width"])
        self.near = float(cam_info.get("near", 0.02))
        self.far = float(cam_info.get("far", 2.0))
        q_rc = torch.tensor(trans["rotation"], dtype=torch.float32, device=self.device)
        self.base_cam_R = transforms.quat_to_matrix(transforms.quat_normalize(q_rc))
        self.base_cam_t = torch.tensor(trans["translation"], dtype=torch.float32,
                                       device=self.device)
        # evaluation uses the nominal camera (sensor.py:22)
        self.randomize = sensor_cfg.get("randomize") if not evaluate else None
        self.rgb_scale = float(sensor_cfg.get("rgb_scale", 255.0))
        self.gripper_substeps = int(tpu.get("gripper_substeps", 48))

    @property
    def action_dim(self):
        return self.actuator_spec.action_dim

    @property
    def obs_shape(self):
        return (self.im_h, self.im_w, 5 if self.full_obs else 2)

    # ------------------------------------------------------------------ camera

    def camera_from_draws(self, dfc, mag, direction, angle, axis):
        """Randomized camera (sensor.py:52-80) from its draws: dfc (B,4)
        offsets of (fx, fy, cx, cy), mag (B,) translation length, direction
        (B,3) and axis (B,3) in [-1,1]^3 (normalised here), angle (B,)."""
        intr = self.base_intrinsics + dfc
        unit = lambda v: v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                                         min=1e-12)
        u = unit(axis)
        half = 0.5 * angle[:, None]
        Rd = transforms.quat_to_matrix(torch.cat([u * torch.sin(half), torch.cos(half)], -1))
        # the rotation turns the whole extrinsic about the gripper origin
        cam_R = torch.einsum("bij,jk->bik", Rd, self.base_cam_R)
        cam_t = torch.einsum("bij,bj->bi", Rd, self.base_cam_t + mag[:, None] * unit(direction))
        return cam_t, cam_R, intr

    def randomized_camera(self, gen, num_envs):
        """Per-episode camera of a training env, drawn with `gen`; the
        nominal camera when randomization is off."""
        B, dev = num_envs, self.device
        if self.randomize is None:
            return (self.base_cam_t.expand(B, 3).clone(), self.base_cam_R.expand(B, 3, 3).clone(),
                    self.base_intrinsics.expand(B, 4).clone())
        r = self.randomize
        f, c = float(r["focal_length"]), float(r["optical_center"])
        uni = lambda shape, lo, hi: lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)
        dfc = torch.cat([uni((B, 2), -f, f), uni((B, 2), -c, c)], -1)
        mag = uni((B,), 0.0, float(r["translation"]))
        direction = uni((B, 3), -1.0, 1.0)
        angle = uni((B,), 0.0, float(r["rotation"]))
        axis = uni((B, 3), -1.0, 1.0)
        return self.camera_from_draws(dfc, mag, direction, angle, axis)

    # ------------------------------------------------------------------ reset

    def reset_env(self, gen, num_envs, lam, settle_substeps=0) -> EnvState:
        """Sample fresh episodes at curriculum difficulty `lam`."""
        cp = curr.params_at(self.curriculum_spec, lam)
        sim = scene.reset_scene(
            gen, self.sim_params, self.type_ids, num_envs, self.max_slots,
            cp["min_objects"], cp["max_objects"], cp["extent"], cp["robot_height"],
            settle_substeps=settle_substeps)
        dev = self.device
        cam_t, cam_R, intrinsics = self.randomized_camera(gen, num_envs)
        return EnvState(
            sim=sim,
            episode_step=torch.zeros(num_envs, dtype=torch.int32, device=dev),
            episode_return=torch.zeros(num_envs, device=dev),
            status=torch.full((num_envs,), rew.RUNNING, dtype=torch.int32, device=dev),
            reward_state=rew.RewardState.init(cp["robot_height"], num_envs, dev),
            cam_t=cam_t, cam_R=cam_R, intrinsics=intrinsics,
            lift_dist=torch.full((num_envs,), cp["lift_dist"], device=dev),
        )

    # ------------------------------------------------------------------ obs

    def assemble_obs(self, state: EnvState, depth, rgb=None):
        """Image observation (robot.py:183-205): depth, then a channel of
        zeros with the actuator width at pixel [0, 0]; RGB-D observations
        put rgb * rgb_scale first. (B, H, W, 2) or (B, H, W, 5)."""
        pad = torch.zeros_like(depth)
        width = physics.gripper_width(state.sim.gripper.q)
        a_obs = act.actuator_obs(self.actuator_spec, width, state.sim.gripper.q[:, 2])
        pad[:, 0, 0] = a_obs[:, 0]
        if self.full_obs:
            return torch.cat([rgb * self.rgb_scale, depth[..., None], pad[..., None]], -1)
        return torch.stack([depth, pad], -1)

    # ------------------------------------------------------------------ step

    def _compose_move_target(self, g, translation, yaw_rotation):
        """relative_pose -> servo targets (robot.py:235-262)."""
        yaw_w = g.q[:, 3]
        cy, sy = torch.cos(yaw_w), torch.sin(yaw_w)
        lx, ly, lz = translation[:, 0], -translation[:, 1], -translation[:, 2]
        dpos = torch.stack([cy * lx - sy * ly, sy * lx + cy * ly, lz], -1)
        new_ee = g.ee_angle + yaw_rotation
        target = torch.cat([g.q[:, :3] + dpos, (-new_ee)[:, None]], -1)
        return target, new_ee

    def _apply_action(self, sim: SimState, action):
        """Decode actions and set servo targets; returns (sim, cmd)."""
        g = sim.gripper
        translation, yaw_rot, cmd = act.decode_action(self.actuator_spec, action, g.gripper_close)
        move_target, move_ee = self._compose_move_target(g, translation, yaw_rot)
        is_move = cmd == act.CMD_MOVE
        target = torch.where(is_move[:, None], move_target, g.target)
        ee = torch.where(is_move, move_ee, g.ee_angle)
        finger_target = torch.where(
            cmd == act.CMD_OPEN, torch.full_like(g.finger_target, FINGER_OPEN),
            torch.where(cmd == act.CMD_CLOSE, torch.full_like(g.finger_target, FINGER_CLOSED),
                        g.finger_target))
        closed = torch.where(cmd == act.CMD_OPEN, torch.zeros_like(g.gripper_close),
                             torch.where(cmd == act.CMD_CLOSE,
                                         torch.ones_like(g.gripper_close), g.gripper_close))
        g = g.replace(target=target, ee_angle=ee, finger_target=finger_target,
                      gripper_close=closed)
        return sim.replace(gripper=g), cmd

    def object_detected(self, sim: SimState, tol=0.005):
        """Finger-stall grasp detection (robot.py:288-297)."""
        width = physics.gripper_width(sim.gripper.q)
        return (sim.gripper.finger_target == FINGER_CLOSED) & (width > tol)

    def _full_outcome_core(self, state: EnvState, sim: SimState):
        h = sim.gripper.q[:, 2]
        detected = self.object_detected(sim)
        reward, status, new_rs = rew.shaped_reward(
            self.reward_spec, state.reward_state, h, detected, state.lift_dist)
        return state.replace(sim=sim, reward_state=new_rs), reward, status

    def _finalize_step(self, gen, state: EnvState, stepped: EnvState, reward, status, lam):
        """Time limit, episode accounting and auto-reset (grasp_env.py:462).
        Returns (next_state, reward, done, info); the observation is made by
        the caller."""
        time_limit = (status == rew.RUNNING) & (stepped.episode_step >= self.time_horizon - 1)
        status = torch.where(time_limit, rew.TIME_LIMIT, status).to(torch.int32)
        done = status != rew.RUNNING
        ep_return = state.episode_return + reward
        ep_step = state.episode_step + 1
        stepped = stepped.replace(episode_step=ep_step, episode_return=ep_return, status=status)
        fresh = self.reset_env(gen, done.shape[0], lam)
        next_state = tree_where(done, fresh, stepped)
        info = {
            "is_success": status == rew.SUCCESS,
            "episode_step": ep_step,
            "episode_return": ep_return,
            "status": status,
            "objects_alive": stepped.sim.objects.alive.to(torch.int32).sum(-1),
        }
        return next_state, reward, done, info


class BatchedGraspEnv:
    """A batch of envs with the kernel-routed step (grasp_env.py:582-642)
    and the shared curriculum window. `generator` draws the auto-reset
    scenes and cameras."""

    def __init__(self, env: GraspEnv, num_envs: int, generator: torch.Generator):
        self.env = env
        self.num_envs = num_envs
        self.gen = generator

    def init_curriculum(self):
        return curr.CurriculumState.init(self.env.curriculum_spec, self.env.evaluate,
                                         self.env.device)

    def reset(self, curriculum: curr.CurriculumState):
        env = self.env
        states = env.reset_env(self.gen, self.num_envs, float(curriculum.lam),
                               settle_substeps=48)
        return states, self.observe_batch(states)

    def observe_batch(self, states: EnvState):
        env = self.env
        cam_pos, cam_R = raycast.camera_pose_from_gripper(
            states.sim.gripper.q, states.cam_t, states.cam_R)
        out = raster_cuda.render_batch(
            states.sim, env.sim_params, cam_pos, cam_R, states.intrinsics,
            H=env.im_h, W=env.im_w, near=env.near, far=env.far, with_rgb=env.full_obs)
        if env.full_obs:
            rgb, depth, _seg = out
            return env.assemble_obs(states, depth, rgb)
        return env.assemble_obs(states, out[0])

    def step(self, states: EnvState, actions, curriculum: curr.CurriculumState):
        """One control step for every env at the curriculum's lambda.
        Returns (states, obs, rewards, dones, infos, curriculum) with VecEnv
        semantics (a finished env's obs already belongs to its next
        episode) and the curriculum window updated with the finished
        episodes (single device: no all-gather)."""
        env = self.env
        sim, _cmd = env._apply_action(states.sim, actions)
        sim = solver_cuda.run_batched_sim(sim, env.sim_params, env.gripper_substeps)
        stepped, reward, status = env._full_outcome_core(states, sim)
        next_states, rewards, dones, infos = env._finalize_step(
            self.gen, states, stepped, reward, status, float(curriculum.lam))
        curriculum = curr.update(env.curriculum_spec, curriculum, dones,
                                 dones & infos["is_success"])
        return next_states, self.observe_batch(next_states), rewards, dones, infos, curriculum
