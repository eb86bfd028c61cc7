"""The port's CUDA kernels on an NVIDIA GPU (marked `cuda`; they skip on a
machine without one, since a CUDA kernel has no CPU mode).

This file imports only torch, numpy and the port, so it runs where JAX is
not installed. Run it on the card without the repo's conftest (which
imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the card, on the
same inputs: the solver at the JAX package's Pallas-vs-XLA grasp tolerance
(2e-3 on positions and gripper coordinates, tests/test_solver_pallas.py),
also at the kernel's limits (K=6 objects of S=8 spheres, SC=4 pair spheres,
the tray: the largest shared-memory request), and two launches of the solver
on the same inputs must give bit-equal outputs (it sums without atomics, in
a fixed order);
the raster's culled launch must equal, bit for bit, a launch with every
live sphere in every tile's sphere list, and a repeat of itself, and the
tile lists it writes must be those of the plain twin of its cull;
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
    training env (randomized camera) of the RGB-D flagship. With
    `max_objects` every slot holds an object."""
    if scene_type == "train":
        env = GraspEnv(cfg_util.load_config(TRAIN_CONFIG), device=dev)
        assert env.randomize is not None
        return env
    cfg = cfg_util.load_config(FLAGSHIP)
    cfg["scene"]["scene_type"] = scene_type
    cfg["tpu"].update(tpu)
    if "max_objects" in tpu:
        cfg["curriculum"]["max_objects"] = [tpu["max_objects"]] * 2
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
    ("OnTable", dict(max_objects=6, oo_spheres=4)),
], ids=["floor", "table", "pinch_knobs_off", "train", "limits"])
def test_solver_kernel_matches_plain(dev, scene_type, tpu):
    env = _env(dev, scene_type, **tpu)
    st = _grasp_batch(env, 128 if scene_type == "train" else 32, seed=1)
    if "max_objects" in tpu:  # the kernel's limits: the largest shared-memory request
        lim = (st.objects.pos.shape[1], env.sim_params.radii.shape[1],
               env.sim_params.oo_radii.shape[1], env.sim_params.has_tray)
        assert lim == (6, 8, 4, True) and bool(st.objects.alive.all())
        assert solver_cuda.launch_config(32, *lim)["shared_bytes"] > 48 * 1024
    before = solver_cuda.run_batch.launches
    a = solver_cuda.run_batched_sim(st, env.sim_params, 16)
    assert solver_cuda.run_batch.launches == before + 1
    b = physics.run(st, env.sim_params, 16)
    for x, y in ((a.gripper.q, b.gripper.q), (a.objects.pos, b.objects.pos)):
        assert bool(torch.isfinite(x).all())
        assert float((x - y).abs().max()) <= 2e-3


def test_solver_kernel_is_deterministic(dev):
    """Two launches on the same inputs give bit-equal outputs."""
    env = _env(dev, "train")
    st = _grasp_batch(env, 128, seed=5)
    ins = solver_cuda.kernel_inputs(st, env.sim_params)
    a = solver_cuda.run_batch(*ins, params=env.sim_params, n_substeps=16)
    b = solver_cuda.run_batch(*ins, params=env.sim_params, n_substeps=16)
    for x, y in zip(a, b):
        assert bool(torch.isfinite(x).all()) and torch.equal(x, y)


def test_solver_kernel_resources(dev):
    """The launch's block fits the compiled kernel; no per-thread stack or
    spill memory."""
    attrs = solver_cuda.kernel_attributes()
    assert attrs["max_threads_per_block"] >= solver_cuda.launch_config(1, 5, 8, 3, False)["threads"]
    assert attrs["local_bytes"] == 0, attrs


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


@pytest.mark.parametrize("scene_type", ["OnFloor", "OnTable", "train"])
@pytest.mark.parametrize("with_shade", [False, True], ids=["depth_seg", "shade"])
def test_raster_cull_is_bit_equal_to_cull_off(dev, scene_type, with_shade):
    """The per-tile sphere lists drop only spheres that no ray of the tile
    hits: a culled launch and one with every live sphere in every tile's
    list give bit-equal depth, seg and shade. A second culled launch, which
    also writes its tile lists, gives the same bits (no atomics). Those
    lists are the plain twin's up to rounding and hold well under all
    pairs; the cull-off launch lists every live sphere."""
    env = _env(dev, scene_type)
    _, args = _raster_args(env, dev)
    kin, kw = raster_cuda.kernel_inputs(*args)
    culled = raster_cuda.raster_depth_seg(*kin, **kw, with_shade=with_shade)
    *off, off_lists = raster_cuda.launch(kin, **kw, with_shade=with_shade, cull=False,
                                         lists=True)
    *again, lists = raster_cuda.launch(kin, **kw, with_shade=with_shade, lists=True)
    for x, y, z in zip(culled, off, again):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert torch.equal(off_lists, (kin[1] > 0)[:, None, :].expand_as(off_lists))
    twin = raster_cuda.check_lists(lists, kin[0], kin[1], kin[5], kin[6], kin[7], 64, 64)
    assert twin == {"listed_beyond_twin": 0, "twin_not_listed": 0}
    assert raster_cuda.pairs_tested(lists, 64, 64) < 0.25


def test_raster_entry_refuses_a_launch_shape_that_does_not_fit(dev):
    """The C entry checks the shared bytes against P, and against the
    device's limit."""
    env = _env(dev)
    _, args = _raster_args(env, dev)
    kin, kw = raster_cuda.kernel_inputs(*args)
    B, P = kin[0].shape[:2]
    lib = build.library()
    out = [torch.empty((B, 64, 64), dtype=dt, device=dev) for dt in (torch.float32, torch.int32)]
    fp = np.asarray([kw["plane_z"], kw["near"], kw["far"], kw["tray_half"], kw["wall_height"]],
                    np.float32)
    cfg = raster_cuda.launch_config(B, P, 64, 64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    huge = 10000  # 240 KB of spheres, over the 227 KiB a block may opt in to
    for p, shared in ((P, cfg["shared_bytes"] - 4),
                      (huge, raster_cuda.launch_config(B, huge, 64, 64)["shared_bytes"])):
        ip = np.asarray([B, p, 64, 64, 0, kw["gripper_id"], 1, shared], np.int32)
        err = lib.raster_run(fp.ctypes.data, ip.ctypes.data, *[t.data_ptr() for t in kin],
                             out[0].data_ptr(), out[1].data_ptr(), None, stream)
        assert err != 0, (p, shared)


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
    assert sorted(lib.paths) == ["raster.cu", "solver.cu"]
    assert all(os.path.isfile(p) for p in lib.paths.values())
    assert np.isfinite(lib.build_seconds)


@pytest.mark.parametrize("algo", ["SAC", "BDQ"])
def test_restored_adam_counts_stay_on_the_cpu(dev, algo, tmp_path):
    """A learner restored from a checkpoint loaded onto the card keeps its
    Adam step counts on the CPU, as a fresh Adam does: a count on the card
    would cost a host sync per parameter and update."""
    from deep_rl_grasping_tpu_torch.algos.bdq import BDQ
    from deep_rl_grasping_tpu_torch.algos.sac import SAC

    cfg = {"SAC": {"layers": [16, 16]}, "BDQ": {"layers": [[16], [8], [8]]}}
    make = (lambda: SAC((20,), 5, cfg, dev)) if algo == "SAC" else (lambda: BDQ((20,), 3, cfg, dev))
    learner = make()
    opts = ((learner.actor_opt, learner.critic_opt, learner.alpha_opt) if algo == "SAC"
            else (learner.opt,))
    for opt in opts:  # one step each, so that every Adam has state
        for group in opt.param_groups:
            for p in group["params"]:
                p.grad = torch.ones_like(p)
        opt.step()
    torch.save(learner.state_dict(), tmp_path / "ckpt.pt")
    payload = torch.load(tmp_path / "ckpt.pt", map_location=dev, weights_only=True)
    restored = make()
    restored.load_state_dict(payload)
    opts = ((restored.actor_opt, restored.critic_opt, restored.alpha_opt) if algo == "SAC"
            else (restored.opt,))
    steps = [s["step"] for opt in opts for s in opt.state.values()]
    assert steps and all(t.device.type == "cpu" and float(t) == 1.0 for t in steps)
    assert all(s["exp_avg"].device.type == "cuda" for opt in opts for s in opt.state.values())
