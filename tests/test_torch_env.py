"""The port's env layer and the evaluation slice vs the JAX package.

* Action decode, shaped reward, curriculum parameters and the task specs
  match the JAX functions on the same inputs (exact, or to float32
  rounding where the arithmetic order differs).
* Whole slice: a 2-env JAX-built reset state, passed through numpy, takes
  2 control steps in the port's `BatchedGraspEnv.step` and in the JAX
  `BatchedGraspEnv.step` with `use_pallas=False`. Observations, rewards and
  dones must match: rewards to 1e-2 (they scale gripper height changes by
  1000, so 1e-5 m of float32 drift shows as 1e-2), dones exactly, and the
  observation to 1e-4 on all but 0.1% of its values (a depth pixel whose
  nearest primitive flips under float32 rounding differs by more).
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


@pytest.fixture(scope="module")
def slice_run():
    cfg = small_config()
    B = 2
    je = jenv.GraspEnv(cfg, evaluate=True, validate=True)
    jb = jenv.BatchedGraspEnv(je, B, use_pallas=False)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    jstates = jax.jit(jax.vmap(lambda k: je.reset_env(k, 1.0, settle_substeps=0)))(keys)
    cur = jb.init_curriculum()
    rng = np.random.default_rng(3)
    actions = rng.uniform(-1.0, 1.0, (2, B, 5)).astype(np.float32)
    actions[1, :, 4] = -1.0  # close the fingers on the second step
    te = tenv.GraspEnv(cfg, evaluate=True, validate=True, device="cpu")
    tb = tenv.BatchedGraspEnv(te, B, torch.Generator().manual_seed(0))
    tstates = _jax_state_to_torch(jstates)
    step = jax.jit(jb.step)
    out = []
    for i in range(2):
        jstates, jobs, jr, jd, jinfo, cur = step(jstates, jnp.asarray(actions[i]), cur)
        tstates, tobs, tr, td, tinfo = tb.step(tstates, torch.as_tensor(actions[i]), 1.0)
        out.append((np.asarray(jobs), np.asarray(jr), np.asarray(jd), tobs.numpy(),
                    tr.numpy(), td.numpy(), np.asarray(jinfo["episode_return"]),
                    tinfo["episode_return"].numpy()))
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_batched_step_matches_jax(slice_run, step):
    jobs, jr, jd, tobs, tr, td, jret, tret = slice_run[step]
    assert tobs.shape == jobs.shape == (2, 64, 64, 2)
    np.testing.assert_array_equal(td, jd)
    assert not jd.any()  # no episode can end in two steps: the step fields stay comparable
    np.testing.assert_allclose(tr, jr, atol=1e-2, rtol=0)
    np.testing.assert_allclose(tret, jret, atol=2e-2, rtol=0)
    off = np.abs(tobs - jobs) > 1e-4
    assert off.mean() <= 1e-3, f"{off.sum()} observation values differ by more than 1e-4"
    # the actuator channel (width / 0.1 at pixel [0, 0]) is exact to rounding
    np.testing.assert_allclose(tobs[:, 0, 0, 1], jobs[:, 0, 0, 1], atol=1e-5)


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
