"""The port's CUDA kernels on an NVIDIA GPU (marked `cuda`; they skip on a
machine without one, since a CUDA kernel has no CPU mode).

This file imports only torch, numpy and the port, so it runs where JAX is
not installed. Run it on the card without the repo's conftest (which
imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card, on the
same inputs: the solver at the JAX package's Pallas-vs-XLA grasp tolerance
(2e-3 on positions and gripper coordinates, tests/test_solver_pallas.py),
the raster with segment ids equal on all but 0.05% of pixels and depth to
1e-4 m on all but 0.5% of the pixels whose ids agree (edge pixels are
ill-conditioned; see chip_smoke.py), and its shade output to 1e-4 on all
but 0.5% of those pixels and 2e-2 on every one (at a crease between two
spheres of one object, against either sphere's shade: `raycast.shade_gap`).
The raster scenes have the gripper yawed, so the finger pads and the camera turn. Each kernel is also
checked on a training env of the RGB-D flagship (`train`): B=128 as
`num_envs` gives it, with a randomized camera pose and intrinsics per env.
"""

import os

import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu_torch.envs.grasp_env import GraspEnv
from deep_rl_grasping_tpu_torch.ops import build, raster_cuda, solver_cuda
from deep_rl_grasping_tpu_torch.render import raycast
from deep_rl_grasping_tpu_torch.sim import physics
from deep_rl_grasping_tpu_torch.sim.types import FINGER_CLOSED
from deep_rl_grasping_tpu_torch.utils import config as cfg_util

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "trained", "sac_full_flagship_r5c", "config.yaml")
TRAIN_CONFIG = os.path.join(REPO, "configs", "sac_rgbd_flagship.yaml")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _env(dev, scene_type="OnFloor", **tpu):
    """An eval env of the depth flagship, or with scene_type "train" a
    training env (randomized camera) of the RGB-D flagship."""
    if scene_type == "train":
        env = GraspEnv(cfg_util.load_config(TRAIN_CONFIG), device=dev)
        assert env.randomize is not None
        return env
    cfg = cfg_util.load_config(FLAGSHIP)
    cfg["scene"]["scene_type"] = scene_type
    cfg["tpu"].update(tpu)
    return GraspEnv(cfg, evaluate=True, validate=True, device=dev)


def _batch_size(env):
    return int(env.config["tpu"]["num_envs"]) if env.randomize is not None else 16


def _grasp_batch(env, B, seed):
    gen = torch.Generator(device=env.device).manual_seed(seed)
    st = env.reset_env(gen, B, 1.0, settle_substeps=8).sim
    half = torch.arange(B, device=env.device) >= B // 2
    q = st.gripper.q.clone()
    q[half, 0:2] = st.objects.pos[half, 0, 0:2]
    q[half, 2] = env.sim_params.support_z + 0.266  # fingertips just above the support
    g = st.gripper.replace(q=q, target=q[:, :4].clone(), finger_target=torch.where(
        half, FINGER_CLOSED, st.gripper.finger_target))
    return st.replace(gripper=g)


@pytest.mark.parametrize("scene_type,tpu", [
    ("OnFloor", {}),
    ("OnTable", {}),
    ("OnFloor", dict(pinch_damping=0.2, oo_point_mass_tangent=False, oo_pass_stride=1)),
    ("train", {}),
], ids=["floor", "table", "pinch_knobs_off", "train"])
def test_solver_kernel_matches_plain(dev, scene_type, tpu):
    env = _env(dev, scene_type, **tpu)
    st = _grasp_batch(env, 128 if scene_type == "train" else 32, seed=1)
    before = solver_cuda.run_batch.launches
    a = solver_cuda.run_batched_sim(st, env.sim_params, 16)
    assert solver_cuda.run_batch.launches == before + 1
    b = physics.run(st, env.sim_params, 16)
    for x, y in ((a.gripper.q, b.gripper.q), (a.objects.pos, b.objects.pos)):
        assert bool(torch.isfinite(x).all())
        assert float((x - y).abs().max()) <= 2e-3


def _raster_args(env, dev):
    B = _batch_size(env)
    st = _grasp_batch(env, B, seed=2)
    q = st.gripper.q.clone()
    q[:, 3] = torch.linspace(-3.0, 3.0, B, device=dev)
    st = st.replace(gripper=st.gripper.replace(q=q))
    es = env.reset_env(torch.Generator(device=dev).manual_seed(3), B, 1.0).replace(sim=st)
    if env.randomize is not None:  # every env sees through its own camera
        assert float((es.intrinsics - es.intrinsics[:1]).abs().max()) > 0
        assert float((es.cam_R - es.cam_R[:1]).abs().max()) > 0
    cam_pos, cam_R = raycast.camera_pose_from_gripper(st.gripper.q, es.cam_t, es.cam_R)
    return st, (st, env.sim_params, cam_pos, cam_R, es.intrinsics, 64, 64, env.near, env.far)


@pytest.mark.parametrize("scene_type", ["OnFloor", "OnTable", "train"])
def test_raster_kernel_matches_plain(dev, scene_type):
    env = _env(dev, scene_type)
    st, args = _raster_args(env, dev)
    before = raster_cuda.raster_depth_seg.launches
    d1, s1 = raster_cuda.render_batch(*args)
    assert raster_cuda.raster_depth_seg.launches == before + 1
    d2, s2 = raycast.render(*args)
    same = s1 == s2
    n = s1.numel()
    assert int((~same).sum()) <= 5e-4 * n
    err = (d1 - d2).abs()[same]
    assert int((err > 1e-4).sum()) <= 5e-3 * n and float(err.max()) <= 5e-3
    obj0 = 3 if scene_type == "OnTable" else 1
    assert bool(((s1 >= obj0) & (s1 < obj0 + 5)).any())


@pytest.mark.parametrize("scene_type", ["OnFloor", "OnTable", "train"])
def test_raster_shade_kernel_matches_plain(dev, scene_type):
    env = _env(dev, scene_type)
    st, args = _raster_args(env, dev)
    kin, kw = raster_cuda.kernel_inputs(*args)
    before = (raster_cuda.raster_depth_seg.launches, raster_cuda.raster_depth_seg.shade_launches)
    d0, s0 = raster_cuda.raster_depth_seg(*kin, **kw)
    d1, s1, sh1 = raster_cuda.raster_depth_seg(*kin, **kw, with_shade=True)
    assert (raster_cuda.raster_depth_seg.launches,
            raster_cuda.raster_depth_seg.shade_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(d0, d1) and torch.equal(s0, s1)  # the shade leaves depth + seg alone
    d2, s2, sh2 = raycast.render_shade(*args)
    same = s1 == s2
    n = s1.numel()
    assert int((~same).sum()) <= 5e-4 * n
    # held to the shade of any hit of the same id within 1e-4 m of the
    # nearest: at a crease between two spheres of one object rounding picks
    # the sphere, and either shade is right
    err = raycast.shade_gap(s1, sh1, raycast.hit_candidates(*args[:7], env.near), 1e-4)[same]
    assert int((err > 1e-4).sum()) <= 5e-3 * n and float(err.max()) <= 2e-2
    assert float(sh1[s1 < 0].abs().max() if bool((s1 < 0).any()) else 0.0) == 0.0
    # the RGB the env gets is shade x id color of the kernel's outputs
    rgb_k, _, _ = raster_cuda.render_batch(*args, with_rgb=True)
    lut = raycast.color_lut(env.sim_params, st.objects.obj_type)
    assert torch.equal(rgb_k, raycast.shade_to_rgb(s1, sh1, lut))


def test_wrappers_check_their_inputs(dev):
    env = _env(dev)
    st = _grasp_batch(env, 4, seed=4)
    ins = list(solver_cuda.kernel_inputs(st, env.sim_params))
    bad = list(ins)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError):
        solver_cuda.run_batch(*bad, params=env.sim_params, n_substeps=1)
    bad = list(ins)
    bad[4] = bad[4].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        solver_cuda.run_batch(*bad, params=env.sim_params, n_substeps=1)
    bad = list(ins)
    bad[5] = bad[5][:, :, :3].contiguous()
    with pytest.raises(ValueError):
        solver_cuda.run_batch(*bad, params=env.sim_params, n_substeps=1)
    with pytest.raises(ValueError):
        raster_cuda.raster_depth_seg(
            torch.zeros(1, 8, 3, device=dev), torch.zeros(1, 8, device=dev),
            torch.zeros(1, 8, dtype=torch.int64, device=dev), torch.zeros(1, 3, 3, device=dev),
            torch.eye(3, device=dev)[None], torch.zeros(1, 3, device=dev),
            torch.eye(3, device=dev)[None], torch.ones(1, 4, device=dev), H=8, W=8,
            has_tray=False, plane_z=-0.196, near=0.02, far=2.0, tray_half=0.21,
            wall_height=0.062, gripper_id=2)


def test_library_is_built_once(dev):
    lib = build.library()
    assert build.library() is lib
    assert os.path.isfile(lib.path)
    assert np.isfinite(lib.build_seconds)
