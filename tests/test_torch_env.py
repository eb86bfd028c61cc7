"""The port's env layer and the evaluation slice vs the JAX package.

* Action decode, shaped reward, curriculum parameters and the task specs
  match the JAX functions on the same inputs (exact, or to float32
  rounding where the arithmetic order differs).
* Whole slice: a 2-env JAX-built reset state, passed through numpy, takes
  2 control steps in the port's `BatchedGraspEnv.step` and in the JAX
  `BatchedGraspEnv.step` with `use_pallas=False`, in the depth and in the
  RGB-D observation mode. Rewards must match to 1e-2 (they scale gripper
  height changes by 1000, so 1e-5 m of float32 drift shows as 1e-2), dones
  and the curriculum window exactly, and the observation to 1e-4 on all but
  0.1% of its values (a pixel whose nearest primitive flips under float32
  rounding differs by more). The observation is held against the JAX
  package's observation of the JAX-stepped states through its Pallas
  raster kernel (interpret mode), the kernel the port replaces: the JAX
  XLA renderer rotates ray directions into the gripper frame the wrong
  way (render/raycast.py:80 vs raster_pallas.py:140-145), which moves the
  finger pads in the image once the gripper has yawed.
* The curriculum window update matches the JAX function exactly on random
  done/success streams that overflow the window and advance lambda.
* The scripted expert matches the JAX expert (no noise, no random actions)
  on JAX-built states, to float32 rounding (1e-5).
* Camera randomization: zero ranges give the nominal camera, draws stay in
  their ranges, and the camera made from given draws matches the JAX
  package's from the same draws (to 1e-6).
* The evaluation harness runs the protocol loop on the CPU.

Sizes are cut for the CPU: the flagship config with K=3 object slots,
4 substeps per control step and a 2 x 2 solver schedule.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu.envs import actuator as jact
from deep_rl_grasping_tpu.envs import curriculum as jcurr
from deep_rl_grasping_tpu.envs import grasp_env as jenv
from deep_rl_grasping_tpu.envs import rewards as jrew
from deep_rl_grasping_tpu.utils import config as jcfg
from deep_rl_grasping_tpu_torch.envs import actuator as tact
from deep_rl_grasping_tpu_torch.envs import curriculum as tcurr
from deep_rl_grasping_tpu_torch.envs import grasp_env as tenv
from deep_rl_grasping_tpu_torch.envs import rewards as trew
from deep_rl_grasping_tpu_torch.sim import scene as tscene
from deep_rl_grasping_tpu_torch.sim import types as ttypes
from deep_rl_grasping_tpu_torch.training.trainer import Evaluator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "trained", "sac_full_flagship_r5c", "config.yaml")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config():
    cfg = jcfg.load_config(FLAGSHIP)
    cfg["tpu"].update(max_objects=3, gripper_substeps=4, solver_iterations=2,
                      pad_inner_iterations=2)
    return cfg


def test_specs_match_jax():
    cfg = small_config()
    for j, t in ((jact.ActuatorSpec, tact.ActuatorSpec), (jrew.RewardSpec, trew.RewardSpec),
                 (jcurr.CurriculumSpec, tcurr.CurriculumSpec)):
        assert dataclasses.asdict(t.from_config(cfg)) == dataclasses.asdict(j.from_config(cfg))


@pytest.mark.parametrize("lam", [0.0, 0.375, 1.0])
def test_curriculum_params_match_jax(lam):
    cfg = small_config()
    j = jcurr.params_at(jcurr.CurriculumSpec.from_config(cfg), jnp.asarray(lam, jnp.float32))
    t = tcurr.params_at(tcurr.CurriculumSpec.from_config(cfg), lam)
    for k, v in t.items():
        np.testing.assert_allclose(v, np.asarray(j[k]), rtol=1e-6, err_msg=k)


def test_decode_action_matches_jax():
    cfg = small_config()
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1.5, 1.5, (64, 5)).astype(np.float32)
    actions[:8, 4] = 0.0
    closed = rng.random(64) < 0.5
    jspec, tspec = jact.ActuatorSpec.from_config(cfg), tact.ActuatorSpec.from_config(cfg)
    jt, jy, jc = jax.vmap(lambda a, c: jact.decode_action(jspec, a, c))(
        jnp.asarray(actions), jnp.asarray(closed))
    tt, ty, tc = tact.decode_action(tspec, torch.as_tensor(actions), torch.as_tensor(closed))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-7)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-7)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    width = rng.uniform(0, 0.1, 64).astype(np.float32)
    np.testing.assert_allclose(
        tact.actuator_obs(tspec, torch.as_tensor(width), torch.zeros(64)).numpy()[:, 0],
        np.asarray(jax.vmap(lambda w: jact.actuator_obs(jspec, w, 0.0))(jnp.asarray(width)))[:, 0],
        rtol=1e-6)


def test_shaped_reward_matches_jax():
    cfg = small_config()
    rng = np.random.default_rng(1)
    n = 64
    lifting = rng.random(n) < 0.5
    start = rng.uniform(0.05, 0.25, n).astype(np.float32)
    old = rng.uniform(0.05, 0.25, n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    det = rng.random(n) < 0.5
    lift = np.full(n, 0.05, np.float32)
    jspec, tspec = jrew.RewardSpec.from_config(cfg), trew.RewardSpec.from_config(cfg)
    jr, js, jrs, _ = jax.vmap(lambda l, s, o, hh, d, ld: jrew.shaped_reward(
        jspec, jrew.RewardState(lifting=l, start_height=s, old_height=o), hh, d, ld))(
        jnp.asarray(lifting), jnp.asarray(start), jnp.asarray(old), jnp.asarray(h),
        jnp.asarray(det), jnp.asarray(lift))
    t = lambda a: torch.as_tensor(a)
    tr, ts, trs = trew.shaped_reward(
        tspec, trew.RewardState(lifting=t(lifting), start_height=t(start), old_height=t(old)),
        t(h), t(det), t(lift))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(trs.lifting.numpy(), np.asarray(jrs.lifting))
    np.testing.assert_allclose(trs.start_height.numpy(), np.asarray(jrs.start_height))


def test_sample_objects_distribution():
    """Deterministic parts of the port's scene sampling: object counts from
    the curriculum, xy inside the extent, unit quaternions, every object at
    or above its resting height, types from the requested split."""
    cfg = small_config()
    env = tenv.GraspEnv(cfg, evaluate=True, validate=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    o = tscene.sample_objects(gen, env.sim_params, env.type_ids, 64, 3, 3, 3, 0.05)
    assert bool(o.alive.all())
    assert float(o.pos[..., :2].abs().max()) <= 0.05
    np.testing.assert_allclose(o.quat.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    assert int(o.obj_type.min()) >= 706 and int(o.obj_type.max()) < 856
    from deep_rl_grasping_tpu_torch.sim import physics
    centers, radii, mask = physics.world_spheres(
        ttypes.SimState(gripper=tscene.init_gripper(0.2, 64, "cpu"), objects=o), env.sim_params)
    lowest = torch.where(mask, centers[..., 2] - radii, torch.full_like(radii, 9.0)).amin(-1)
    assert float(lowest.min()) >= env.sim_params.support_z


def _jax_state_to_torch(s):
    def np_(a):
        return np.asarray(a)
    sim = ttypes.sim_state_from_numpy({
        f"{part}.{f.name}": np_(getattr(getattr(s.sim, part), f.name))
        for part in ("gripper", "objects")
        for f in dataclasses.fields(getattr(s.sim, part))})
    t = lambda a: torch.as_tensor(np.array(a))
    rs = s.reward_state
    return tenv.EnvState(
        sim=sim, episode_step=t(s.episode_step), episode_return=t(s.episode_return),
        status=t(s.status),
        reward_state=trew.RewardState(lifting=t(rs.lifting), start_height=t(rs.start_height),
                                      old_height=t(rs.old_height)),
        cam_t=t(s.cam_t), cam_R=t(s.cam_R), intrinsics=t(s.intrinsics), lift_dist=t(s.lift_dist))


def _pallas_obs(je, jstates):
    """The JAX package's batched observation through its Pallas raster
    (BatchedGraspEnv.observe_batch with use_pallas), in interpret mode."""
    from deep_rl_grasping_tpu.ops.raster_pallas import render_batch_pallas
    from deep_rl_grasping_tpu.render import raycast as jraycast

    cam_pos, cam_R = jax.vmap(jraycast.camera_pose_from_gripper)(
        jstates.sim.gripper.q, jstates.cam_t, jstates.cam_R)
    out = render_batch_pallas(jstates.sim, je.sim_params, cam_pos, cam_R, jstates.intrinsics,
                              H=je.im_h, W=je.im_w, near=je.near, far=je.far,
                              interpret=True, with_rgb=je.full_obs)
    if je.full_obs:
        return np.asarray(jax.vmap(je.assemble_obs)(jstates, *out))
    return np.asarray(jax.vmap(lambda st, d, m: je.assemble_obs(st, None, d, m))(jstates, *out))


def _curriculum_np(c):
    return {f: np.asarray(getattr(c, f)) for f in
            ("lam", "ring", "ptr", "filled", "sr_mean", "policy_iteration")}


def _run_slice(cfg, evaluate, end_first_env=False):
    """Two control steps of 2 envs in both packages from one JAX-built reset
    state. With `end_first_env`, env 0 starts one step before its time
    limit, so its episode ends in the second step."""
    B = 2
    je = jenv.GraspEnv(cfg, evaluate=evaluate, validate=evaluate)
    jb = jenv.BatchedGraspEnv(je, B, use_pallas=False)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    jstates = jax.jit(jax.vmap(lambda k: je.reset_env(k, 1.0, settle_substeps=0)))(keys)
    if end_first_env:
        jstates = jstates.replace(episode_step=jnp.asarray([je.time_horizon - 2, 0], jnp.int32))
    cur = jb.init_curriculum()
    rng = np.random.default_rng(3)
    actions = rng.uniform(-1.0, 1.0, (2, B, 5)).astype(np.float32)
    actions[1, :, 4] = -1.0  # close the fingers on the second step
    te = tenv.GraspEnv(cfg, evaluate=evaluate, validate=evaluate, device="cpu")
    tb = tenv.BatchedGraspEnv(te, B, torch.Generator().manual_seed(0))
    tstates = _jax_state_to_torch(jstates)
    tcur = tb.init_curriculum()
    step = jax.jit(jb.step)
    out = []
    for i in range(2):
        jstates, _jobs, jr, jd, jinfo, cur = step(jstates, jnp.asarray(actions[i]), cur)
        tstates, tobs, tr, td, tinfo, tcur = tb.step(tstates, torch.as_tensor(actions[i]), tcur)
        out.append(dict(jobs=_pallas_obs(je, jstates), jr=np.asarray(jr), jd=np.asarray(jd),
                        tobs=tobs.numpy(), tr=tr.numpy(), td=td.numpy(),
                        jret=np.asarray(jinfo["episode_return"]),
                        tret=tinfo["episode_return"].numpy(),
                        jcur=_curriculum_np(cur), tcur=_curriculum_np(tcur)))
    return out


@pytest.fixture(scope="module")
def slice_run():
    return _run_slice(small_config(), evaluate=True)


def _check_step(r, channels, live):
    """Hold one step's outputs against JAX; `live` selects the envs whose
    observation still belongs to the episode both packages stepped."""
    jobs, tobs = r["jobs"], r["tobs"]
    assert tobs.shape == jobs.shape == (2, 64, 64, channels)
    np.testing.assert_array_equal(r["td"], r["jd"])
    np.testing.assert_allclose(r["tr"], r["jr"], atol=1e-2, rtol=0)
    np.testing.assert_allclose(r["tret"], r["jret"], atol=2e-2, rtol=0)
    for k, v in r["jcur"].items():
        np.testing.assert_array_equal(r["tcur"][k], v, err_msg=k)
    off = np.abs(tobs[live] - jobs[live]) > 1e-4
    assert off.mean() <= 1e-3, f"{off.sum()} observation values differ by more than 1e-4"
    # the actuator channel (width / 0.1 at pixel [0, 0]) is exact to rounding
    np.testing.assert_allclose(tobs[live, 0, 0, -1], jobs[live, 0, 0, -1], atol=1e-5)


@pytest.mark.parametrize("step", [0, 1])
def test_batched_step_matches_jax(slice_run, step):
    r = slice_run[step]
    assert not r["jd"].any()  # no episode can end in two steps: the step fields stay comparable
    _check_step(r, 2, [0, 1])


def rgbd_config():
    """The RGB-D flagship cut like small_config(): 5-channel observations,
    unit-range RGB, camera randomization in the training envs."""
    cfg = jcfg.load_config(os.path.join(REPO, "configs", "sac_rgbd_flagship.yaml"))
    cfg["tpu"].update(max_objects=3, gripper_substeps=4, solver_iterations=2,
                      pad_inner_iterations=2)
    return cfg


@pytest.fixture(scope="module")
def rgbd_slice_run():
    return _run_slice(rgbd_config(), evaluate=False, end_first_env=True)


@pytest.mark.parametrize("step", [0, 1])
def test_rgbd_step_matches_jax(rgbd_slice_run, step):
    """Training envs (randomized cameras carried over in the state). Env 0
    ends its episode at the time limit in the second step: both packages
    then start a fresh episode from their own generators, so only env 1's
    observation is compared there; the ended episode enters the curriculum
    window of both."""
    r = rgbd_slice_run[step]
    np.testing.assert_array_equal(r["jd"], [step == 1, False])
    _check_step(r, 5, [0, 1] if step == 0 else [1])
    assert int(r["tcur"]["filled"]) == step
    rgb = r["tobs"][..., :3]
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0 and rgb.max() > 0.1


def test_evaluation_harness_runs_the_protocol_loop():
    """Two envs, a 3-step horizon: every episode ends at the time limit and
    the harness reports it."""
    from deep_rl_grasping_tpu_torch.models.networks import SACActor
    from deep_rl_grasping_tpu_torch.algos.normalize import NormalizerState

    cfg = small_config()
    cfg["time_horizon"] = 3
    torch.manual_seed(0)
    actor = SACActor((64, 64, 2), 5, (16, 16), image_obs=True)
    norm = NormalizerState.init((64, 64, 2), 2)
    res = Evaluator(cfg, device="cpu").evaluate(actor, norm, n_episodes=2)
    assert res["episodes"] == 2 and res["control_steps"] == 3
    assert res["mean_length"] == 3.0
    assert 0.0 <= res["success_rate"] <= 1.0 and np.isfinite(res["mean_return"])


def test_run_refuses_cuda_without_a_card():
    from deep_rl_grasping_tpu_torch.training import train

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit):
        train.main(["run", "--npz", os.path.join(REPO, "trained", "sac_full_flagship_r5c"),
                    "--episodes", "1"])


def test_curriculum_update_matches_jax():
    """Random done/success streams over 40 steps of 16 envs against an
    8-episode window: more episodes than the window holds end in one step,
    full windows slide, lambda advances and the window clears."""
    cfg = small_config()
    cfg["curriculum"].update(window_size=8, n_steps=4, success_threshold=0.5)
    jspec = jcurr.CurriculumSpec.from_config(cfg)
    tspec = tcurr.CurriculumSpec.from_config(cfg)
    jstate = jcurr.CurriculumState.init(jspec)
    tstate = tcurr.CurriculumState.init(tspec)
    rng = np.random.default_rng(7)
    update = jax.jit(lambda s, d, k: jcurr.update(jspec, s, d, k))
    advanced = 0
    for i in range(40):
        done = rng.random(16) < (0.9 if i % 5 == 0 else 0.2)
        succ = rng.random(16) < 0.8
        jstate = update(jstate, jnp.asarray(done), jnp.asarray(succ))
        tstate = tcurr.update(tspec, tstate, torch.as_tensor(done), torch.as_tensor(succ))
        for f in ("lam", "ring", "ptr", "filled", "sr_mean", "policy_iteration"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.asarray(getattr(jstate, f)), err_msg=f)
        advanced = int(tstate.policy_iteration) - 1
    assert advanced >= 2 and float(tstate.lam) == min(advanced / 4, 1.0)


def _expert_states(cfg):
    """JAX-built reset states with the gripper placed over, beside and on
    the nearest object, open, closed and holding: every branch of the
    expert is taken by some env."""
    je = jenv.GraspEnv(cfg, evaluate=True, validate=True)
    B = 12
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    js = jax.jit(jax.vmap(lambda k: je.reset_env(k, 1.0, settle_substeps=0)))(keys)
    rng = np.random.default_rng(5)
    q = np.asarray(js.sim.gripper.q).copy()
    pos = np.asarray(js.sim.objects.pos)
    q[:, 0:2] = pos[:, 0, 0:2] + rng.uniform(-0.02, 0.02, (B, 2)) * (np.arange(B) % 3 != 0)[:, None]
    floor_q2 = je.sim_params.support_z + 0.187 + 0.075
    q[:, 2] = np.where(np.arange(B) % 2 == 0, floor_q2 + 0.005, 0.2)
    q[:, 3] = rng.uniform(-1.0, 1.0, B)
    # closed envs of index 3 mod 4 are fully shut on nothing (width 0), the others hold
    q[:, 4:6] = np.where((np.arange(B) % 4 == 3)[:, None], 0.05, 0.02)
    closed = np.arange(B) % 4 >= 2
    g = js.sim.gripper.replace(
        q=jnp.asarray(q), gripper_close=jnp.asarray(closed),
        ee_angle=jnp.asarray(rng.uniform(-1.0, 1.0, B).astype(np.float32)),
        finger_target=jnp.asarray(np.where(closed, 0.05, 0.0).astype(np.float32)))
    js = js.replace(sim=js.sim.replace(gripper=g))
    # turn the envs of index 0 mod 6 to the pinch alignment the expert wants
    from deep_rl_grasping_tpu.envs import scripted as jscripted

    _, perr = jax.vmap(lambda s: jscripted._yaw_align(je, s, 0))(js)
    q[:, 3] += np.where(np.arange(B) % 6 == 0, np.asarray(perr), 0.0)
    return je, js.replace(sim=js.sim.replace(gripper=g.replace(q=jnp.asarray(q))))


def test_scripted_expert_matches_jax():
    from deep_rl_grasping_tpu.envs import scripted as jscripted
    from deep_rl_grasping_tpu_torch.envs import scripted as tscripted

    cfg = small_config()
    je, js = _expert_states(cfg)
    ja = np.asarray(jax.jit(jax.vmap(lambda s, k: jscripted.scripted_full_action(
        je, s, k, noise=0.0, p_random=0.0)))(js, jax.random.split(jax.random.PRNGKey(0), 12)))
    te = tenv.GraspEnv(cfg, evaluate=True, validate=True, device="cpu")
    ta = tscripted.scripted_full_action(te, _jax_state_to_torch(js), torch.Generator(),
                                        noise=0.0, p_random=0.0).numpy()
    np.testing.assert_allclose(ta, ja, atol=1e-5, rtol=0)
    # the states reach every branch: servo moves, descents, closes, reopens and lifts
    assert (ja[:, 4] == -1).any() and (ja[:, 4] == 1).any() and (ja[:, 2] == -1).any()
    assert (np.abs(ja[:, 3]) > 0).any()


def test_scripted_expert_noise_stays_in_range():
    from deep_rl_grasping_tpu_torch.envs import scripted as tscripted

    cfg = small_config()
    te = tenv.GraspEnv(cfg, evaluate=True, validate=True, device="cpu")
    gen = torch.Generator().manual_seed(1)
    st = te.reset_env(gen, 64, 1.0)
    a0 = tscripted.scripted_full_action(te, st, gen, noise=0.0, p_random=0.0)
    a = tscripted.scripted_full_action(te, st, gen, noise=0.3, p_random=0.5)
    assert a.shape == (64, 5) and float(a.abs().max()) <= 1.0
    assert not torch.equal(a, a0)


def test_camera_randomization():
    cfg = rgbd_config()
    ranges = dict(cfg["sensor"]["randomize"])
    gen = torch.Generator().manual_seed(0)
    cfg["sensor"]["randomize"] = dict(focal_length=0, optical_center=0, translation=0,
                                      rotation=0.0)
    te = tenv.GraspEnv(cfg, device="cpu")
    t, R, intr = te.randomized_camera(gen, 8)
    np.testing.assert_allclose(intr.numpy(), te.base_intrinsics.expand(8, 4).numpy())
    np.testing.assert_allclose(R.numpy(), te.base_cam_R.expand(8, 3, 3).numpy(), atol=1e-7)
    np.testing.assert_allclose(t.numpy(), te.base_cam_t.expand(8, 3).numpy(), atol=1e-7)

    cfg["sensor"]["randomize"] = ranges
    te = tenv.GraspEnv(cfg, device="cpu")
    t, R, intr = te.randomized_camera(gen, 256)
    d = (intr - te.base_intrinsics).numpy()
    f, c = float(ranges["focal_length"]), float(ranges["optical_center"])
    assert np.abs(d[:, :2]).max() <= f and np.abs(d[:, 2:]).max() <= c
    assert np.abs(d[:, :2]).max() > 0.5 * f
    rel = torch.einsum("bij,kj->bik", R, te.base_cam_R)  # Rd = R base^T
    angle = torch.arccos(torch.clamp((rel.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2, -1, 1))
    assert float(angle.max()) <= float(ranges["rotation"]) + 1e-3
    # Rd^T t - t0 is the translation offset, at most `translation` long
    off = torch.einsum("bji,bj->bi", rel, t) - te.base_cam_t
    assert float(off.norm(dim=-1).max()) <= float(ranges["translation"]) + 1e-6
    # nothing but the camera changes in evaluation envs
    assert tenv.GraspEnv(cfg, evaluate=True, device="cpu").randomize is None

    # the same draws give the JAX package's camera (grasp_env.py:198-222)
    je = jenv.GraspEnv(cfg)
    key = jax.random.PRNGKey(3)
    jt, jR, jintr = je._randomized_camera(key)
    kf, kc, kt, kd, kr, ka = jax.random.split(key, 6)
    r = cfg["sensor"]["randomize"]
    u = lambda k, shape, lo, hi: np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
    dfc = np.concatenate([u(kf, (2,), -f, f), u(kc, (2,), -c, c)])[None]
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tt, tR, tintr = te.camera_from_draws(
        T(dfc), T(u(kt, (), 0.0, float(r["translation"])))[None],
        T(u(kd, (3,), -1.0, 1.0))[None], T(u(kr, (), 0.0, float(r["rotation"])))[None],
        T(u(ka, (3,), -1.0, 1.0))[None])
    np.testing.assert_allclose(tintr[0].numpy(), np.asarray(jintr), atol=1e-5)
    np.testing.assert_allclose(tR[0].numpy(), np.asarray(jR), atol=1e-6)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(jt), atol=1e-6)
