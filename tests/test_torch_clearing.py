"""Table clearing, the full-task env contracts and the folded SAC update in
the port vs the JAX package, on the CPU at a small size.

(a) The env contracts of tests/test_env_contract.py for the `continuous`
    and `rgbd` configs (the other cases are held in
    tests/test_torch_encoder.py and tests/test_torch_discrete.py):
    spaces, the first zero-action step's reward of exactly -11, the zero
    action holding the height, the close action closing; the port's
    `EvalMixin.evaluate` is deterministic and evaluates at lambda 1.
(b) `rewards.table_clearing_reward` against the JAX function on random
    inputs, exactly; `_remove_highest` against the JAX one, exactly (the
    highest *alive* object dies, the fingers, their target and the close
    latch go back to open).
(c) One clearing control step (`BatchedGraspEnv.step`) of 4 envs from one
    JAX-built OnTable tray state, in both packages: env 0 lifts with three
    objects alive (reward `lift_success`, RUNNING, its highest object
    dead, fingers open), env 1 lifts its last object (`terminal_reward`,
    SUCCESS), env 2 holds an object but has not lifted it by `lift_dist`
    (the shaped running reward, nothing removed), env 3 holds nothing.
    Statuses, dones, alive flags, `objects_alive` and the lift rewards
    exactly; the shaped reward to 1e-2 (height changes are scaled by
    1000); the dead object leaves the render. The "hold" is made by
    closing the fingers on no object: they take longer than the step's
    substeps to shut, so the finger-stall detection fires in both packages.
(d) `evaluate`'s `mean_cleared` and per-episode cleared counts from those
    states with a 3-step horizon against the JAX step looped with the
    reference's counting rule (initial alive count minus the post-step
    count at the first done, trainer.py:169-216).
(e) The scripted full-task expert steers at the nearest *alive* object,
    as the JAX expert does, when a dead one lies nearer.
(f) One folded SAC update (`tpu.update_batch_scale` 8 on
    configs/sac_simplified_batched_quality.yaml cut to 16 hidden units):
    both trainers fold 32 updates of batch 16 into 4 of batch 128 with a
    32-row demonstration tail, and one update from the same Flax state,
    batch and normal draws matches JAX as tests/test_torch_algos.py holds
    an unfolded one (float32 networks on both sides; the critic and BC
    losses to 1e-4 relative, parameters to 2 x the learning rate, all but
    0.5% to 1e-6). The actor loss and the entropy hold to 1e-3 relative:
    among 128 draws some actions saturate the tanh, where the log-prob's
    log(1 - a^2 + 1e-6) magnifies the two frameworks' float32 tanh
    rounding (seen: 3e-4). The learning-rate decay counts that update as
    one gradient step.

The JAX envs are built once per module at B=4 with 4 substeps of 2
solver iterations, reset with no settle.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deep_rl_grasping_tpu.envs import grasp_env as jenv  # noqa: E402
from deep_rl_grasping_tpu.envs import rewards as jrew  # noqa: E402
from deep_rl_grasping_tpu.envs import scripted as jscripted  # noqa: E402
from deep_rl_grasping_tpu.models import networks as jnet  # noqa: E402
from deep_rl_grasping_tpu.training import trainer as jtrainer  # noqa: E402
from deep_rl_grasping_tpu.utils import config as jcfg  # noqa: E402
from deep_rl_grasping_tpu_torch.envs import grasp_env as tenv  # noqa: E402
from deep_rl_grasping_tpu_torch.envs import rewards as trew  # noqa: E402
from deep_rl_grasping_tpu_torch.envs import scripted as tscripted  # noqa: E402
from deep_rl_grasping_tpu_torch.models import networks as tnet  # noqa: E402
from deep_rl_grasping_tpu_torch.sim.types import FINGER_CLOSED, FINGER_OPEN  # noqa: E402
from deep_rl_grasping_tpu_torch.training import trainer as ttrainer  # noqa: E402
from deep_rl_grasping_tpu_torch.training.train import set_precision  # noqa: E402
from deep_rl_grasping_tpu_torch.utils import policy_io  # noqa: E402
CONTRACT_CONFIGS = {"continuous": os.path.join(REPO, "tests", "configs", "test_continuous.yaml"),
                    "rgbd": os.path.join(REPO, "tests", "configs", "test_rgbd.yaml")}
B = 4
LIFT_SUCCESS = 5000.0


@pytest.fixture(scope="module", autouse=True)
def _threads():
    set_precision()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(s):
    """A JAX env state as the flat numpy arrays `env_state_from_numpy` reads."""
    out = {}
    for part in ("gripper", "objects"):
        sub = getattr(s.sim, part)
        for f in dataclasses.fields(sub):
            out[f"{part}.{f.name}"] = np.asarray(getattr(sub, f.name))
    for f in tenv._ENV_FIELDS:
        out[f] = np.asarray(getattr(s, f))
    for f in tenv._REWARD_FIELDS:
        out[f"reward_state.{f}"] = np.asarray(getattr(s.reward_state, f))
    return out


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("name", list(CONTRACT_CONFIGS))
def test_env_contract(name):
    """Spaces, the first zero-action step's reward and the kinematics
    (tests/test_env_contract.py:46-158) at the configs' own schedules."""
    cfg = jcfg.load_config(CONTRACT_CONFIGS[name])
    cfg["tpu"].update(max_objects=2, solver_iterations=1, pad_inner_iterations=1)
    env = tenv.GraspEnv(cfg, device="cpu")
    je = jenv.GraspEnv(jcfg.load_config(CONTRACT_CONFIGS[name]))
    assert env.obs_shape == je.obs_shape == {"continuous": (64, 64, 2), "rgbd": (64, 64, 5)}[name]
    assert not env.discrete and not env.simplified and env.action_dim == je.action_dim == 5
    benv = tenv.BatchedGraspEnv(env, 2, torch.Generator().manual_seed(0))
    cur = benv.init_curriculum()
    with torch.no_grad():
        states, obs = benv.reset(cur)
        z0 = states.sim.gripper.q[:, 2].clone()
        stepped, obs2, reward, done, _, _ = benv.step(states, torch.zeros(2, 5), cur)
        assert obs.shape == obs2.shape == (2,) + env.obs_shape
        assert np.isfinite(obs2.numpy()).all() and not done.any()
        assert reward.tolist() == [-11.0, -11.0]
        np.testing.assert_allclose((stepped.sim.gripper.q[:, 2] - z0).numpy(), 0.0, atol=1e-3)
        close = torch.zeros(2, 5)
        close[:, -1] = -1.0  # a -1 in the last slot closes the gripper
        closed, *_ = benv.step(stepped, close, cur)
    assert bool(closed.sim.gripper.gripper_close.all())
    assert bool((closed.sim.gripper.finger_target == FINGER_CLOSED).all())


class ZeroActor(torch.nn.Module):
    """A SAC-actor stand-in whose deterministic action is 0 everywhere."""

    def forward(self, obs):
        z = torch.zeros(obs.shape[0], 5)
        return z, z


def test_evaluation_is_deterministic_and_at_full_difficulty():
    """Two evaluations give the same scenes and results (the fixed scene
    seed, simulation.py:91-100), and the eval env starts at lambda 1."""
    cfg = jcfg.load_config(CONTRACT_CONFIGS["continuous"])
    cfg["tpu"].update(max_objects=2, solver_iterations=1, pad_inner_iterations=1)
    cfg.update(time_horizon=1, normalize=False)
    ev = ttrainer.Evaluator(cfg, device="cpu")
    runs = [ev.evaluate(ZeroActor(), None, n_episodes=2) for _ in range(2)]
    assert runs[0] == runs[1] and runs[0]["episodes"] == 2
    eval_env = tenv.GraspEnv(cfg, evaluate=True, device="cpu")
    assert float(tenv.BatchedGraspEnv(eval_env, 2, None).init_curriculum().lam) == 1.0
    assert eval_env.randomize is None  # the nominal camera at evaluation
    gen = lambda: torch.Generator().manual_seed(ttrainer.SCENE_SEED)
    a, b = eval_env.reset_env(gen(), 2, 1.0), eval_env.reset_env(gen(), 2, 1.0)
    assert torch.equal(a.sim.objects.pos, b.sim.objects.pos)
    assert float(a.lift_dist.min()) == pytest.approx(0.1)  # lambda 1's lift distance


# ------------------------------------------------------------------ (b)

def _clearing_config():
    cfg = jcfg.load_config(CONTRACT_CONFIGS["continuous"])
    cfg["reward"].update(custom=True, table_clearing=True, lift_success=LIFT_SUCCESS)
    cfg["tpu"].update(max_objects=3, gripper_substeps=4, solver_iterations=2,
                      pad_inner_iterations=2)
    return cfg


def test_table_clearing_reward_matches_jax():
    spec_t = trew.RewardSpec.from_config(_clearing_config())
    spec_j = jrew.RewardSpec.from_config(_clearing_config())
    rng = np.random.default_rng(3)
    n = 64
    h = rng.uniform(0.05, 0.4, n).astype(np.float32)
    rs = dict(lifting=rng.random(n) < 0.5, start_height=rng.uniform(0.05, 0.4, n).astype(
        np.float32), old_height=rng.uniform(0.05, 0.4, n).astype(np.float32))
    detected = rng.random(n) < 0.6
    lift = rng.uniform(0.0, 0.1, n).astype(np.float32)
    alive = rng.integers(0, 4, n).astype(np.int32)
    got = trew.table_clearing_reward(
        spec_t, trew.RewardState(**{k: torch.as_tensor(v) for k, v in rs.items()}),
        torch.as_tensor(h), torch.as_tensor(detected), torch.as_tensor(lift),
        torch.as_tensor(alive))
    ref = jax.vmap(lambda r, hh, d, l, a: jrew.table_clearing_reward(
        spec_j, jrew.RewardState(**r), hh, d, l, a))(
        {k: jnp.asarray(v) for k, v in rs.items()}, h, detected, lift, alive)
    for g, r in zip((got[0], got[1], got[3]), (ref[0], ref[1], ref[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for f in ("lifting", "start_height", "old_height"):
        np.testing.assert_array_equal(getattr(got[2], f).numpy(), np.asarray(getattr(ref[2], f)))
    lifted = got[3].numpy()
    assert lifted.any() and (lifted & (alive <= 1)).any() and (lifted & (alive > 1)).any()
    assert not got[2].lifting.numpy()[lifted].any()  # the latch resets after a clear
    assert set(got[0].numpy()[lifted & (alive > 1)]) == {LIFT_SUCCESS}


@pytest.fixture(scope="module")
def clearing():
    """The JAX and port envs of the clearing config, and 4 JAX-built reset
    states arranged as (c) describes; the JAX step, jitted once."""
    cfg = _clearing_config()
    je = jenv.GraspEnv(cfg, evaluate=True, validate=True)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    js = jax.jit(jax.vmap(lambda k: je.reset_env(k, 1.0, settle_substeps=0)))(keys)
    flat = _flat(js)
    assert (flat["objects.alive"].sum(-1) == 3).all()
    alive = flat["objects.alive"].copy()
    alive[1, 1:] = False  # env 1 holds its last object
    flat["objects.alive"] = alive
    ft = flat["gripper.finger_target"].copy()
    ft[:3] = FINGER_CLOSED  # envs 0-2 hold; env 3 keeps its fingers open
    flat["gripper.finger_target"] = ft
    flat["gripper.gripper_close"] = ft == FINGER_CLOSED
    flat["lift_dist"] = np.asarray([-1.0, -1.0, 0.5, -1.0], np.float32)
    # a dead object above the others in env 1: the highest ALIVE one must go
    pos = flat["objects.pos"].copy()
    pos[1, 2, 2] = 0.5
    flat["objects.pos"] = pos
    js = _to_jax(js, flat)
    jb = jenv.BatchedGraspEnv(je, B, use_pallas=False)
    cur = jb.init_curriculum()
    step = jax.jit(jb.step)
    env = tenv.GraspEnv(cfg, evaluate=True, validate=True, device="cpu")
    return cfg, je, js, flat, step, cur, env


def _to_jax(js, flat):
    sim = js.sim.replace(
        gripper=js.sim.gripper.replace(**{f.name: jnp.asarray(flat[f"gripper.{f.name}"])
                                          for f in dataclasses.fields(js.sim.gripper)}),
        objects=js.sim.objects.replace(**{f.name: jnp.asarray(flat[f"objects.{f.name}"])
                                          for f in dataclasses.fields(js.sim.objects)}))
    return js.replace(sim=sim, lift_dist=jnp.asarray(flat["lift_dist"]))


def test_remove_highest_matches_jax(clearing):
    _, je, js, flat, _, _, env = clearing
    ref = jax.vmap(je._remove_highest)(js.sim)
    got = env._remove_highest(tenv.env_state_from_numpy(flat).sim)
    np.testing.assert_array_equal(got.objects.alive.numpy(), np.asarray(ref.objects.alive))
    np.testing.assert_array_equal(got.gripper.q.numpy(), np.asarray(ref.gripper.q))
    assert (got.gripper.finger_target.numpy() == FINGER_OPEN).all()
    assert not got.gripper.gripper_close.numpy().any()
    # env 1's highest object is dead already: its one alive object goes
    assert got.objects.alive.numpy()[1].tolist() == [False, False, False]
    assert got.objects.alive.numpy().sum() == 3 * B - 2 - B


# ------------------------------------------------------------------ (c)

def test_clearing_step_matches_jax(clearing):
    _, je, js, flat, step, jcur, env = clearing
    jstates, _, jr, jd, jinfo, _ = step(js, jnp.zeros((B, 5)), jcur)
    benv = tenv.BatchedGraspEnv(env, B, torch.Generator().manual_seed(0))
    cur = benv.init_curriculum()
    with torch.no_grad():
        stepped, reward, status = benv.step_core(tenv.env_state_from_numpy(flat),
                                                 torch.zeros(B, 5))
        nxt, obs, r, d, info, _ = benv.step(tenv.env_state_from_numpy(flat), torch.zeros(B, 5),
                                            cur)
    jr, jd = np.asarray(jr), np.asarray(jd)
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_array_equal(info["status"].numpy(), np.asarray(jinfo["status"]))
    np.testing.assert_array_equal(info["objects_alive"].numpy(),
                                  np.asarray(jinfo["objects_alive"]))
    assert info["status"].tolist() == [trew.RUNNING, trew.SUCCESS, trew.RUNNING, trew.RUNNING]
    assert r.tolist()[:2] == jr.tolist()[:2] == [LIFT_SUCCESS, 10.0]  # terminal_reward 10
    assert r[3] == jr[3] == -100.0  # the time penalty alone: nothing held
    np.testing.assert_allclose(r[2].item(), jr[2], atol=1e-2)
    assert r[2] > -100.0 + 0.5  # the grasp reward of a held object
    assert info["objects_alive"].tolist() == [2, 0, 3, 3]
    # env 0 goes on with its highest object dead and its fingers open; the
    # others keep theirs (env 1 was reset after its success)
    got = tenv.env_state_to_numpy(nxt)
    ref = _flat(jstates)
    for e in (0, 2, 3):
        np.testing.assert_array_equal(got["objects.alive"][e], ref["objects.alive"][e])
        np.testing.assert_allclose(got["gripper.q"][e], ref["gripper.q"][e], atol=1e-5)
    hi = int(np.argmax(np.where(flat["objects.alive"][0],
                                stepped.sim.objects.pos[0, :, 2].numpy(), -np.inf)))
    assert not got["objects.alive"][0][hi] and got["objects.alive"][0].sum() == 2
    assert got["gripper.finger_target"][0] == FINGER_OPEN and not got["gripper.gripper_close"][0]
    np.testing.assert_array_equal(got["gripper.q"][0, 4:6], [FINGER_OPEN, FINGER_OPEN])
    assert not got["reward_state.lifting"][0]
    # the dead object leaves the render: no pixel carries its seg id
    from deep_rl_grasping_tpu_torch.ops import raster_cuda
    from deep_rl_grasping_tpu_torch.render import raycast

    cam_pos, cam_R = raycast.camera_pose_from_gripper(nxt.sim.gripper.q, nxt.cam_t, nxt.cam_R)
    _, seg = raster_cuda.render_batch(nxt.sim, env.sim_params, cam_pos, cam_R, nxt.intrinsics)
    assert not (seg[0] == 3 + hi).any()


# ------------------------------------------------------------------ (d)

def test_evaluate_counts_cleared_objects_as_jax(clearing):
    cfg, je, js, flat, step, jcur, _ = clearing
    horizon = 3
    # the JAX step looped with the reference's first-done counting
    init_alive = flat["objects.alive"].sum(-1)
    done_once = np.zeros(B, bool)
    cleared = np.zeros(B, np.int64)
    ret, succ = np.zeros(B), np.zeros(B, bool)
    s = js
    for t in range(horizon):
        s, _, r, d, info, _ = step(s, jnp.zeros((B, 5)), jcur)
        d = np.asarray(d) | (t == horizon - 1)
        first = d & ~done_once
        cleared = np.where(first, init_alive - np.asarray(info["objects_alive"]), cleared)
        ret = np.where(first, np.asarray(info["episode_return"]), ret)
        succ = np.where(first, np.asarray(info["is_success"]), succ)
        done_once |= d
    ev = ttrainer.Evaluator(dict(cfg, time_horizon=horizon, normalize=False), device="cpu")
    res = ev.evaluate(ZeroActor(), None, n_episodes=B,
                      initial_states=tenv.env_state_from_numpy(flat))
    assert res["episodes"] == B and res["control_steps"] <= horizon
    assert res["episode_cleared"] == cleared.tolist() == [1, 1, 0, 0]
    assert res["mean_cleared"] == pytest.approx(cleared.mean())
    assert res["success_rate"] == pytest.approx(succ.mean()) and succ.tolist()[1]
    np.testing.assert_allclose(res["mean_return"], ret.mean(), atol=1e-2)


# ------------------------------------------------------------------ (e)

def test_expert_aims_at_the_nearest_alive_object(clearing):
    _, je, js, flat, _, _, env = clearing
    arr = {k: v.copy() for k, v in flat.items()}
    q = arr["gripper.q"]
    arr["gripper.finger_target"][:] = FINGER_OPEN
    arr["gripper.gripper_close"][:] = False
    pos = arr["objects.pos"]
    q[:, :2] = pos[:, 0, :2] + 0.001  # slot 0 lies right under the gripper ...
    arr["objects.alive"][:, 0] = False  # ... and is dead
    arr["objects.alive"][:, 1] = True
    ref = jax.vmap(lambda s, k: jscripted.scripted_full_action(je, s, k, noise=0.0,
                                                               p_random=0.0))(
        _to_jax(js, arr), jax.random.split(jax.random.PRNGKey(0), B))
    got = tscripted.scripted_full_action(env, tenv.env_state_from_numpy(arr),
                                         torch.Generator().manual_seed(0), noise=0.0,
                                         p_random=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # it steers away from the dead slot towards an alive one (no descent yet)
    assert (np.abs(got.numpy()[:, :2]).max(-1) > 0.05).all()
    assert (got.numpy()[:, 2] == 0.0).all()


# ------------------------------------------------------------------ (f)

def _batched_config():
    cfg = jcfg.load_config(os.path.join(REPO, "configs", "sac_simplified_batched_quality.yaml"))
    cfg["SAC"].update(layers=[16, 16], batch_size=16, buffer_size=64, lr_decay_steps=10,
                      lr_decay_begin=0, lr_final_scale=0.1)
    cfg["tpu"].update(num_envs=2)
    return cfg


@pytest.fixture
def float32_networks(monkeypatch):
    monkeypatch.setattr(jnet, "CDTYPE", jnp.float32)
    monkeypatch.setattr(tnet, "CDTYPE", torch.float32)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))


def test_folded_sac_update_matches_jax(float32_networks):
    jt = jtrainer.Trainer(_batched_config())
    tt = ttrainer.Trainer(_batched_config(), device="cpu")
    assert jt.updates_per_step == tt.updates_per_step == 4
    assert jt.algo.batch_size == tt.algo.batch_size == tt.batch_size == 128
    assert jt.algo.bc_tail == tt.algo.bc_tail == 32
    obs_shape, A, N = tt.env.obs_shape, tt.env.action_dim, 128
    assert obs_shape == (100,) and A == 3
    rng = np.random.default_rng(4)
    batch = dict(
        obs=rng.normal(size=(N,) + obs_shape).astype(np.float32),
        next_obs=rng.normal(size=(N,) + obs_shape).astype(np.float32),
        action=rng.uniform(-0.9, 0.9, (N, A)).astype(np.float32),
        reward=rng.normal(0.0, 0.3, N).astype(np.float32),
        done=rng.random(N) < 0.3, weight=np.ones(N, np.float32),
        is_demo=np.arange(N) >= N - 32)
    batch["discount"] = (0.99 * ~batch["done"]).astype(np.float32)
    state = jt.algo.init(jax.random.PRNGKey(0))
    state = state.replace(actor_params=jax.tree.map(
        lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(np.float32),
        state.actor_params))
    key = jax.random.PRNGKey(5)
    new_state, jm, _ = jax.jit(jt.algo.update)(state, {k: jnp.asarray(v) for k, v in
                                                       batch.items()}, key)
    eps = [torch.as_tensor(np.asarray(jax.random.normal(k, (N, A))))
           for k in jax.random.split(key)]
    talgo = tt.algo
    policy_io.load_sac_state(talgo, _np(state.actor_params), _np(state.critic_params),
                             _np(state.target_critic_params), np.asarray(state.log_alpha))
    tm, _ = talgo.update({k: torch.as_tensor(v) for k, v in batch.items()}, noise=tuple(eps))
    for k in ("critic_loss", "bc_loss", "alpha_loss", "q_target_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("actor_loss", "entropy"):  # log(1 - tanh^2 + 1e-6) at saturated draws
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)
    assert float(jm["bc_loss"]) > 0
    lr = 3e-4
    pairs = [(talgo.actor.state_dict(),
              policy_io.actor_state_dict(_np(new_state.actor_params), talgo.actor)),
             (talgo.critic.state_dict(),
              policy_io.critic_state_dict(_np(new_state.critic_params), talgo.critic))]
    diffs = np.concatenate([(t[k] - j[k]).abs().reshape(-1).numpy()
                            for t, j in pairs for k in j])
    assert diffs.max() <= 2 * lr + 1e-6 and (diffs > 1e-6).mean() <= 5e-3
    # one folded update is one gradient step of the decay (sac.py:103)
    assert talgo.step == int(new_state.step) == 1 and int(new_state.critic_opt[0].count) == 1
    assert talgo.lr_at(talgo.step) == pytest.approx(lr * (1 - 0.9 / 10), rel=1e-6)


# ------------------------------------------------------------------ expert

def test_expert_rollouts_report_per_episode(clearing):
    """tools/expert_rate.py on the clearing config (2 envs, a 3-step
    horizon): one result per episode, counted as `evaluate` counts them."""
    from deep_rl_grasping_tpu_torch.tools import expert_rate

    cfg = dict(_clearing_config(), time_horizon=3)
    res = expert_rate.expert_rollouts(cfg, n_episodes=2, lam=0.0, device="cpu")
    assert res["episodes"] == 2 and res["control_steps"] == 3
    assert len(res["episode_cleared"]) == len(res["episode_success"]) == 2
    assert res["mean_length"] == 3.0 and res["success_rate"] == 0.0


def jax_expert_rollouts(config_path, n_episodes, lam, seed=0):
    """The JAX package's expert under tools/expert_rate.py's protocol (its
    training env and split, noise 0.1, 10% random actions, each env until
    its first episode ends), on the CPU; scenes from PRNGKey(seed)."""
    import time

    cfg = jcfg.load_config(config_path)
    je = jenv.GraspEnv(cfg)
    jb = jenv.BatchedGraspEnv(je, n_episodes, use_pallas=False)
    cur = jb.init_curriculum().replace(lam=jnp.asarray(lam, jnp.float32))
    t0 = time.perf_counter()
    states, _ = jax.jit(jb.reset)(jax.random.PRNGKey(seed), cur)
    init_alive = np.asarray(states.sim.objects.alive).sum(-1)

    @jax.jit
    def step(states, key):
        keys = jax.random.split(key, n_episodes)
        actions = jax.vmap(lambda s, k: jscripted.scripted_full_action(je, s, k))(states, keys)
        states, _, _, dones, infos, _ = jb.step(states, actions, cur)
        return states, dones, infos

    key = jax.random.PRNGKey(seed + 1)
    done_once = np.zeros(n_episodes, bool)
    succ, cleared = np.zeros(n_episodes, bool), np.zeros(n_episodes, np.int64)
    t = 0
    while t < je.time_horizon and not done_once.all():
        key, k = jax.random.split(key)
        states, dones, infos = step(states, k)
        dones = np.asarray(dones)
        first = dones & ~done_once
        succ = np.where(first, np.asarray(infos["is_success"]), succ)
        cleared = np.where(first, init_alive - np.asarray(infos["objects_alive"]), cleared)
        done_once |= dones
        t += 1
    n = max(done_once.sum(), 1)
    return dict(lam=lam, episodes=int(done_once.sum()),
                success_rate=float((succ & done_once).sum() / n),
                mean_cleared=float(np.where(done_once, cleared, 0).sum() / n),
                episode_success=succ.tolist(), episode_cleared=cleared.tolist(),
                control_steps=t, wall_seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    # The JAX package's expert on the clearing config, on the CPU:
    #   JAX_PLATFORMS=cpu python tests/test_torch_clearing.py [--episodes N] [lam ...]
    import json

    argv = sys.argv[1:]
    n = 128
    if "--episodes" in argv:
        i = argv.index("--episodes")
        n = int(argv[i + 1])
        del argv[i:i + 2]
    jax.config.update("jax_platforms", "cpu")
    for lam in [float(a) for a in argv] or [0.0, 1.0]:
        res = jax_expert_rollouts(os.path.join(REPO, "configs", "sac_table_clearing.yaml"), n, lam)
        print(json.dumps(res), flush=True)
