"""The grasping task, batched (port of deep_rl_grasping_tpu/envs/grasp_env.py).

`GraspEnv` holds the static task configuration and the per-env glue
(action decode, servo targets, reward, time limit, auto-reset, observation
assembly), all written over a leading env axis. `BatchedGraspEnv.step` is
the kernel-routed step of grasp_env.py:582-642. The full task makes one
solver call for `gripper_substeps` (ops/solver_cuda.py). The simplified
task (:592-606) makes three: the commanded move for `move_substeps`, the
grasp attempt (the fingers close where the gripper is below 7 cm) for
`gripper_substeps`, and a 5 cm lift of the triggered envs for
`2 * move_substeps`. Then one render (ops/raster_cuda.py: depth + seg, or
with the shade for RGB-D observations) and the curriculum window update.
On CUDA tensors both go through the CUDA kernels; on CPU tensors through
their plain versions. Training envs draw a randomized camera per episode
(grasp_env.py:198-222).

Three observation modes: depth (64, 64, 2), RGB-D (64, 64, 5), and the
encoder latent when neither image mode is set (grasp_env.py:286-323): the
depth image with the support, the tray walls and the gripper masked out by
the render's seg ids goes through the trained encoder the caller passes in
(training/train_encoder.py); the full task appends the actuator
observation, and `time_feature` the remaining-time fraction. On the
simplified task the depth observation's second channel is all zeros (the
reference's padding channel, robot.py:193-199) and the latent is
encoding_dim wide.

Actions are decoded by envs/actuator.py: continuous, flat discrete, or,
with `branched_actions` (set for BDQ), one bin per action dimension.

Table clearing (`reward.table_clearing`, on the OnTable tray): a lift
clears the highest alive object, which goes dead in the live state (the
solver and the raster skip dead objects), and reopens the gripper; the
episode succeeds when the last object is cleared (grasp_env.py:377-390,
:425-441). `info["objects_alive"]` is the post-step count before the
auto-reset, so an episode's cleared count is its first count minus this
at its end.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from deep_rl_grasping_tpu_torch.envs import actuator as act
from deep_rl_grasping_tpu_torch.envs import curriculum as curr
from deep_rl_grasping_tpu_torch.envs import rewards as rew
from deep_rl_grasping_tpu_torch.envs import wrappers
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
    sim_state_from_numpy,
    sim_state_to_numpy,
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


_ENV_FIELDS = ("episode_step", "episode_return", "status", "cam_t", "cam_R", "intrinsics",
               "lift_dist")
_REWARD_FIELDS = ("lifting", "start_height", "old_height")


def env_state_to_numpy(state: EnvState) -> dict:
    """A flat dict of numpy arrays keyed by the JAX package's field names
    (`gripper.q`, `objects.pos`, `reward_state.lifting`, `cam_R`, ...)."""
    out = sim_state_to_numpy(state.sim)
    for f in _ENV_FIELDS:
        out[f] = getattr(state, f).detach().cpu().numpy()
    for f in _REWARD_FIELDS:
        out[f"reward_state.{f}"] = getattr(state.reward_state, f).detach().cpu().numpy()
    return out


def env_state_from_numpy(arrays, device="cpu") -> EnvState:
    """The inverse of `env_state_to_numpy`; also reads env states the JAX
    package saved under the same names."""
    t = lambda a, dtype: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    kinds = {"episode_step": torch.int32, "status": torch.int32}
    return EnvState(
        sim=sim_state_from_numpy(arrays, device),
        reward_state=rew.RewardState(
            lifting=t(arrays["reward_state.lifting"], torch.bool),
            start_height=t(arrays["reward_state.start_height"], torch.float32),
            old_height=t(arrays["reward_state.old_height"], torch.float32)),
        **{f: t(arrays[f], kinds.get(f, torch.float32)) for f in _ENV_FIELDS})


def observation_shape(config):
    """The observation shape of a (defaults-filled) config's env
    (grasp_env.py:187-194): (H, W, 2) depth, (H, W, 5) RGB-D, else latents,
    (encoding_dim + 1,) on the full task and (encoding_dim,) on the
    simplified one, one more with `time_feature`."""
    if config.get("depth_observation") or config.get("full_observation"):
        info = io_utils.load_yaml(cfg_util.resolve_path(config["sensor"]["camera_info"]))
        return (int(info["height"]), int(info["width"]),
                5 if config.get("full_observation") else 2)
    d = int(config.get("encoding_dim", 100)) + (0 if config.get("simplified") else 1)
    return (d + 1,) if config.get("time_feature") else (d,)


class GraspEnv:
    """Static task configuration + batched transition functions. `encoder`
    (depth images (B, H, W, 1) -> latents (B, encoding_dim)) is required
    for encoder-latent observations and unused otherwise."""

    def __init__(self, config, evaluate=False, test=False, validate=False, device="cuda",
                 encoder=None):
        config = cfg_util.load_config(config)
        self.config = config
        self.evaluate = evaluate
        self.device = torch.device(device)
        tpu = config["tpu"]
        self.simplified = bool(config["simplified"])
        self.depth_obs = bool(config.get("depth_observation", False))
        self.full_obs = bool(config.get("full_observation", False))
        if self.simplified and self.full_obs:
            # the JAX package's simplified observation has 2 channels where
            # its obs_shape says 5 (grasp_env.py:187-189, :273-276)
            raise ValueError("the simplified task has no RGB-D observation")
        self.image_obs = self.depth_obs or self.full_obs
        self.encoding_dim = int(config.get("encoding_dim", 100))
        if not self.image_obs and getattr(encoder, "encoding_dim", None) != self.encoding_dim:
            raise ValueError(f"encoder-latent observations need an encoder of "
                             f"{self.encoding_dim} latents, got {encoder!r}")
        self.encoder = encoder
        self.time_horizon = int(config["time_horizon"])
        # the remaining-time feature goes on flat observations only
        # (grasp_env.py:95-97)
        self.time_feature = bool(config.get("time_feature", False)) and not self.image_obs
        self.actuator_spec = act.ActuatorSpec.from_config(config)
        self.reward_spec = rew.RewardSpec.from_config(config)
        self.curriculum_spec = curr.CurriculumSpec.from_config(config)

        scene_cfg = config["scene"]
        self.scene_type = scene_cfg.get("scene_type", "OnFloor" if self.simplified else "OnTable")
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
        self.move_substeps = int(tpu.get("move_substeps", 24))
        self.gripper_substeps = int(tpu.get("gripper_substeps", 48))
        self.obs_shape = observation_shape(config)
        # BDQ's composite actions, one bin per action dimension (set with
        # the BDQ block's pad count by training/trainer.py
        # `set_action_interface`)
        self.branched_actions = False

    @property
    def discrete(self):
        return self.actuator_spec.discrete

    @property
    def num_actions(self):
        return self.actuator_spec.num_discrete_actions

    @property
    def action_dim(self):
        return self.actuator_spec.action_dim

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

    def encoder_input(self, depth, seg):
        """The encoder's input (sensor.py:206-230, grasp_env.py:287-295): the
        depth image with every pixel zeroed whose seg id is 0 (the plane) or
        the gripper's, and on OnTable also 1 or 2 (table, tray); ids as in
        render/raycast.py. (B, H, W)."""
        gripper_id = self.max_slots + 3 if self.sim_params.has_tray else self.max_slots + 1
        drop = (seg == 0) | (seg == gripper_id)
        if self.scene_type == "OnTable":
            drop |= (seg == 1) | (seg == 2)
        return torch.where(drop, torch.zeros_like(depth), depth)

    def assemble_obs(self, state: EnvState, depth, rgb=None, seg=None):
        """Image observation (robot.py:183-205): depth, then a channel of
        zeros with the actuator width at pixel [0, 0]; RGB-D observations
        put rgb * rgb_scale first; the simplified task's second channel is
        all zeros. (B, H, W, 2) or (B, H, W, 5). Latent observation (needs
        `seg`): the encoded masked depth, on the full task the actuator
        observation, and with `time_feature` the remaining time;
        (B, encoding_dim [+ 1] [+ 1])."""
        width = physics.gripper_width(state.sim.gripper.q)
        a_obs = act.actuator_obs(self.actuator_spec, width, state.sim.gripper.q[:, 2])
        if not self.image_obs:
            obs = self.encoder(self.encoder_input(depth, seg)[..., None])
            if not self.simplified:
                obs = torch.cat([obs, a_obs], -1)
            if self.time_feature:
                obs = wrappers.append_time_feature(obs, state.episode_step, self.time_horizon)
            return obs
        pad = torch.zeros_like(depth)
        if self.simplified:
            return torch.stack([depth, pad], -1)
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
        if self.branched_actions:
            translation, yaw_rot, cmd = act.decode_branched_action(self.actuator_spec, action)
        else:
            translation, yaw_rot, cmd = act.decode_action(self.actuator_spec, action,
                                                          g.gripper_close)
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

    def _simplified_trigger(self, sim: SimState):
        """The grasp attempt's trigger (grasp_env.py:398-407): the fingers
        close where the gripper is below 7 cm. Returns (sim, trigger, the
        gripper height before the attempt)."""
        g = sim.gripper
        h = g.q[:, 2]
        trigger = h < 0.07
        g = g.replace(
            finger_target=torch.where(trigger, torch.full_like(g.finger_target, FINGER_CLOSED),
                                      g.finger_target),
            gripper_close=g.gripper_close | trigger)
        return sim.replace(gripper=g), trigger, h

    def _simplified_lift(self, sim: SimState, trigger):
        """Raise the triggered envs' z target by 5 cm (grasp_env.py:409-413)."""
        g = sim.gripper
        target = g.target.clone()
        target[:, 2] += torch.where(trigger, 0.05, 0.0)
        return sim.replace(gripper=g.replace(target=target))

    def _simplified_outcome_core(self, state: EnvState, sim: SimState, trigger, h):
        """The attempt's verdict where it was triggered, the descent's
        elsewhere (grasp_env.py:415-423)."""
        r_attempt, s_attempt = rew.simplified_outcome(self.object_detected(sim))
        r_move, s_move, rs_move = rew.simplified_descend(self.reward_spec, state.reward_state, h)
        reward = torch.where(trigger, r_attempt, r_move)
        status = torch.where(trigger, s_attempt, s_move)
        return state.replace(sim=sim, reward_state=rs_move), reward, status

    def _remove_highest(self, sim: SimState):
        """Table clearing: the highest alive object goes dead, and the
        fingers, their target and the close latch go back to open
        (grasp_env.py:377-390)."""
        obj, g = sim.objects, sim.gripper
        z = torch.where(obj.alive, obj.pos[..., 2], torch.full_like(obj.pos[..., 2], -math.inf))
        hi = torch.argmax(z, -1)
        alive = obj.alive.clone()
        alive[torch.arange(alive.shape[0], device=alive.device), hi] = False
        q = g.q.clone()
        q[:, 4:6] = FINGER_OPEN
        g = g.replace(q=q, finger_target=torch.full_like(g.finger_target, FINGER_OPEN),
                      gripper_close=torch.zeros_like(g.gripper_close))
        return sim.replace(objects=obj.replace(alive=alive), gripper=g)

    def _full_outcome_core(self, state: EnvState, sim: SimState):
        h = sim.gripper.q[:, 2]
        detected = self.object_detected(sim)
        if self.reward_spec.table_clearing:
            num_alive = sim.objects.alive.to(torch.int32).sum(-1)
            reward, status, new_rs, clear = rew.table_clearing_reward(
                self.reward_spec, state.reward_state, h, detected, state.lift_dist, num_alive)
            sim = tree_where(clear, self._remove_highest(sim), sim)
        else:
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
        depth, seg = out
        return env.assemble_obs(states, depth, seg=seg)

    def step_core(self, states: EnvState, actions):
        """The control step before the time limit and the auto-reset:
        decode, the solver call(s), reward and status (grasp_env.py:592-613).
        Returns (stepped states, reward, status)."""
        env, params = self.env, self.env.sim_params
        sim, _cmd = env._apply_action(states.sim, actions)
        if env.simplified:
            sim = solver_cuda.run_batched_sim(sim, params, env.move_substeps)
            sim, trigger, h = env._simplified_trigger(sim)
            sim = solver_cuda.run_batched_sim(sim, params, env.gripper_substeps)
            sim = env._simplified_lift(sim, trigger)
            sim = solver_cuda.run_batched_sim(sim, params, 2 * env.move_substeps)
            return env._simplified_outcome_core(states, sim, trigger, h)
        sim = solver_cuda.run_batched_sim(sim, params, env.gripper_substeps)
        return env._full_outcome_core(states, sim)

    def step(self, states: EnvState, actions, curriculum: curr.CurriculumState):
        """One control step for every env at the curriculum's lambda.
        Returns (states, obs, rewards, dones, infos, curriculum) with VecEnv
        semantics (a finished env's obs already belongs to its next
        episode) and the curriculum window updated with the finished
        episodes (single device: no all-gather)."""
        env = self.env
        stepped, reward, status = self.step_core(states, actions)
        next_states, rewards, dones, infos = env._finalize_step(
            self.gen, states, stepped, reward, status, float(curriculum.lam))
        curriculum = curr.update(env.curriculum_spec, curriculum, dones,
                                 dones & infos["is_success"])
        return next_states, self.observe_batch(next_states), rewards, dones, infos, curriculum
