"""The simplified task, the discrete and branched actions, DQN, BDQ and
prioritized replay in the port vs the JAX package.

(a) Action decode for every action index: the flat simplified
    Discrete(3 x pads) at 4 and 8 pads, the full task's Discrete(11)
    table, the branched bins (3 branches of 8 on the simplified task, 5
    branches with a middle no-op bin on the full task), and the continuous
    simplified decode: exact to float32 rounding (1e-7).
(b) `simplified_descend` and `simplified_outcome`: exact.
(c) One simplified control step from the same JAX-built state on
    tests/configs/test_encoder_simp.yaml with the trained encoder
    (encoder_files/full_r4), cut to 4 envs, 3 object slots and a short
    schedule, with BDQ's branched actions at 8 pads. Two envs start below
    the 7 cm trigger over an object, two above it. Before the auto-reset
    (`step_core` vs the JAX `_step_core`): rewards and statuses exactly,
    gripper coordinates and object poses to 1e-4 (22 substeps of float32
    contact solving in two summation orders, through a grasp squeeze).
    After it: rewards, dones and statuses exactly; the 100-wide latent of
    the envs that go on to 3e-2 of the JAX package's (its Pallas raster in
    interpret mode and its encoder; tests/test_torch_encoder.py on why).
(d) `QNetwork` and `BDQNetwork` with the `trained/dqn_simplified_r5` and
    `trained/bdq_simplified_r5` weights against the Flax modules on the
    same latents (random ones and the 8 real ones of the JAX validation
    scenes): Q values to 2e-2 (the MLPs compute in bfloat16 in both
    packages and round at other places; the gaps seen are up to 1.7e-2),
    greedy actions equal wherever the top two Q values of a row (or branch)
    are further apart than twice the largest gap seen, where no rounding
    can swap them, and on at least 95% of all rows.
(e) One `DQN.update` and one `BDQ.update` from the same params (Flax
    params carried across with `policy_io.load_q_state`) and the same
    batch with importance weights, the networks in float32 on both sides
    (as tests/test_torch_algos.py does for SAC): loss and |TD| per row to
    1e-5 relative, the updated params to 1e-6 on all but 0.5% of them and
    to 2 x the learning rate everywhere (Adam's first step can flip sign
    on a gradient within rounding of zero), the target params copied on an
    update-frequency step and untouched otherwise.
(f) Prioritized replay: inserts at the ring's largest priority, the
    sampling distribution and the importance weights of JAX's draws, the
    rows gathered for them, and `update_priorities`, all against the JAX
    buffer (probabilities and weights to 1e-6 relative: the same formulas,
    sums in another order); a chi-square test (p = 0.001) of the port's
    draw frequencies on a small ring.
(g) One `Trainer` iteration each for DQN and BDQ on the simplified configs
    cut to 2 envs: integer action columns, prioritized updates that change
    priorities, BDQ's pad override on the training and evaluation envs.
(h) The env contract of tests/test_env_contract.py for the
    `simplified_cont`, `encoder_simp` and `discrete` configs: action and
    observation spaces, the first zero-action step's reward (0 on the
    simplified task, -11 on the full one) and the kinematics (the
    simplified task descends 5 mm per step, the full task holds height).

The JAX envs are built at 4 envs in one module-scoped fixture.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from deep_rl_grasping_tpu.algos import bdq as jbdq
from deep_rl_grasping_tpu.algos import dqn as jdqn
from deep_rl_grasping_tpu.algos import replay as jreplay
from deep_rl_grasping_tpu.envs import actuator as jact
from deep_rl_grasping_tpu.envs import grasp_env as jenv
from deep_rl_grasping_tpu.envs import rewards as jrew
from deep_rl_grasping_tpu.models import networks as jnet
from deep_rl_grasping_tpu.training import train_encoder as jte
from deep_rl_grasping_tpu.utils import config as jcfg
from deep_rl_grasping_tpu.utils import policy_io as jpolicy_io
from deep_rl_grasping_tpu_torch.algos import replay as treplay
from deep_rl_grasping_tpu_torch.algos.bdq import BDQ
from deep_rl_grasping_tpu_torch.algos.dqn import DQN
from deep_rl_grasping_tpu_torch.envs import actuator as tact
from deep_rl_grasping_tpu_torch.envs import grasp_env as tenv
from deep_rl_grasping_tpu_torch.envs import rewards as trew
from deep_rl_grasping_tpu_torch.models import networks as tnet
from deep_rl_grasping_tpu_torch.training import train as ttrain
from deep_rl_grasping_tpu_torch.training import train_encoder as tte
from deep_rl_grasping_tpu_torch.training.trainer import Trainer, set_action_interface
from deep_rl_grasping_tpu_torch.utils import policy_io
from tests.test_torch_env import _pallas_obs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {name: os.path.join(REPO, "tests", "configs", f"test_{name}.yaml")
           for name in ("simplified_cont", "encoder_simp", "discrete")}
ENCODER_DIR = os.path.join(REPO, "encoder_files", "full_r4")
BDQ_BUNDLE = os.path.join(REPO, "trained", "bdq_simplified_r5")
DQN_BUNDLE = os.path.join(REPO, "trained", "dqn_simplified_r5")
B = 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))


def _config(name, **robot):
    cfg = jcfg.load_config(CONFIGS[name])
    cfg["robot"].update(robot)
    return cfg


# ------------------------------------------------------------------ (a)

def _jax_decode(spec, actions, closed):
    return [np.asarray(x) for x in jax.vmap(lambda a, c: jact.decode_action(spec, a, c))(
        jnp.asarray(actions), jnp.asarray(closed))]


@pytest.mark.parametrize("simplified,pads", [(True, 4), (True, 8), (False, 2)],
                         ids=["simplified_4pads", "simplified_8pads", "full_11"])
def test_flat_discrete_decode_matches_jax(simplified, pads):
    cfg = _config("encoder_simp", discrete=True, num_actions_pad=pads)
    cfg["simplified"] = simplified
    jspec, tspec = jact.ActuatorSpec.from_config(cfg), tact.ActuatorSpec.from_config(cfg)
    n = tspec.num_discrete_actions
    assert n == jspec.num_discrete_actions == (3 * pads if simplified else 11)
    # every action, with the gripper open and closed
    actions = np.tile(np.arange(n, dtype=np.int32), 2)
    closed = np.repeat([False, True], n)
    jt, jy, jc = _jax_decode(jspec, actions, closed)
    tt, ty, tc = tact.decode_action(tspec, torch.as_tensor(actions), torch.as_tensor(closed))
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-7, rtol=0)
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-7, rtol=0)
    np.testing.assert_array_equal(tc.numpy(), jc)
    if simplified:
        np.testing.assert_allclose(tt[:, 2].numpy(), 0.005)  # the constant descent
    else:  # open is refused while open, close while closed
        assert tc.tolist() == [0] * 10 + [2] + [0] * 9 + [1, 0]


@pytest.mark.parametrize("simplified,pads", [(True, 8), (False, 3)],
                         ids=["simplified_3x8", "full_5x3"])
def test_branched_decode_matches_jax(simplified, pads):
    cfg = _config("encoder_simp", num_actions_pad=pads)
    cfg["simplified"] = simplified
    jspec, tspec = jact.ActuatorSpec.from_config(cfg), tact.ActuatorSpec.from_config(cfg)
    nb = 3 if simplified else 5
    bins = np.stack(np.meshgrid(*[np.arange(pads)] * nb, indexing="ij"), -1).reshape(-1, nb)
    bins = bins.astype(np.int32)
    jt, jy, jc = [np.asarray(x) for x in jax.vmap(
        lambda b: jact.decode_branched_action(jspec, b))(jnp.asarray(bins))]
    tt, ty, tc = tact.decode_branched_action(tspec, torch.as_tensor(bins))
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-7, rtol=0)
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-7, rtol=0)
    np.testing.assert_array_equal(tc.numpy(), jc)
    if not simplified:  # bin 0 closes, the middle bin moves, the last opens
        np.testing.assert_array_equal(tc.numpy(), np.choose(bins[:, 4], [2, 0, 1]))


def test_continuous_simplified_decode_matches_jax():
    cfg = _config("simplified_cont")
    jspec, tspec = jact.ActuatorSpec.from_config(cfg), tact.ActuatorSpec.from_config(cfg)
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    closed = rng.random(64) < 0.5
    jt, jy, jc = _jax_decode(jspec, actions, closed)
    tt, ty, tc = tact.decode_action(tspec, torch.as_tensor(actions), torch.as_tensor(closed))
    np.testing.assert_allclose(tt.numpy(), jt, atol=1e-7, rtol=0)
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-7, rtol=0)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert tspec.action_dim == 3 and (np.abs(actions[:, 2]) > 1).any()


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("stalled", [True, False])
def test_simplified_rewards_match_jax(stalled):
    cfg = _config("encoder_simp")
    cfg["reward"]["stalled"] = stalled
    jspec, tspec = jrew.RewardSpec.from_config(cfg), trew.RewardSpec.from_config(cfg)
    rng = np.random.default_rng(1)
    n = 64
    old = rng.uniform(0.05, 0.3, n).astype(np.float32)
    h = (old - rng.uniform(-0.002, 0.008, n)).astype(np.float32)
    lifting = rng.random(n) < 0.5
    start = rng.uniform(0.05, 0.3, n).astype(np.float32)
    jr, js, jrs = jax.vmap(lambda l, s, o, hh: jrew.simplified_descend(
        jspec, jrew.RewardState(lifting=l, start_height=s, old_height=o), hh))(
        jnp.asarray(lifting), jnp.asarray(start), jnp.asarray(old), jnp.asarray(h))
    t = torch.as_tensor
    tr, ts, trs = trew.simplified_descend(
        tspec, trew.RewardState(lifting=t(lifting), start_height=t(start), old_height=t(old)),
        t(h))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(trs.old_height.numpy(), np.asarray(jrs.old_height))
    np.testing.assert_array_equal(trs.lifting.numpy(), np.asarray(jrs.lifting))
    assert (ts.numpy() == trew.FAIL).any() == stalled and (ts.numpy() == trew.RUNNING).any()
    det = rng.random(n) < 0.5
    jr, js = jax.vmap(jrew.simplified_outcome)(jnp.asarray(det))
    tr, ts = trew.simplified_outcome(t(det))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------------------ (c)

def step_config():
    """test_encoder_simp.yaml with the trained encoder, cut to 3 object
    slots and a short schedule, BDQ at 8 pads."""
    cfg = _config("encoder_simp")
    cfg["sensor"]["encoder_dir"] = "encoder_files/full_r4"
    cfg["tpu"].update(max_objects=3, move_substeps=6, gripper_substeps=4, solver_iterations=2,
                      pad_inner_iterations=2)
    cfg["BDQ"] = {"num_actions_pad": 8}
    return cfg


def _flat(s):
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


@pytest.fixture(scope="module")
def simplified_step():
    """One branched control step of B envs in both packages from one
    JAX-built reset state: envs 0 and 1 start at 6.8 cm over an object
    (the step triggers their grasp attempt), envs 2 and 3 at 30 cm."""
    cfg = step_config()
    enc_fn, _ = jte.load_trained_encoder(ENCODER_DIR)
    je = jenv.GraspEnv(cfg, evaluate=True, validate=True, encoder_fn=enc_fn)
    je.branched_actions = True
    je.actuator_spec = dataclasses.replace(je.actuator_spec, num_actions_pad=8)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    js = jax.jit(jax.vmap(lambda k: je.reset_env(k, 1.0, settle_substeps=0)))(keys)
    q = np.array(js.sim.gripper.q)
    obj = np.asarray(js.sim.objects.pos)
    q[:2, :2] = obj[:2, 0, :2]
    q[:2, 2] = 0.068
    q[:, 3] = [0.3, -1.2, 2.0, 0.0]
    g = js.sim.gripper.replace(q=jnp.asarray(q), target=jnp.asarray(q[:, :4]))
    js = js.replace(sim=js.sim.replace(gripper=g))
    bins = np.array([[3, 4, 2], [7, 0, 5], [0, 7, 7], [4, 3, 0]], np.int32)
    stepped, jr, jstatus = jax.jit(jax.vmap(je._step_core))(js, jnp.asarray(bins))
    nxt, jr2, jdone, jinfo = jax.jit(jax.vmap(
        lambda st, sp, r, su: je._finalize_step(st, sp, r, su, 1.0, with_obs=False)))(
        js, stepped, jr, jstatus)
    te = tenv.GraspEnv(cfg, evaluate=True, validate=True, device="cpu",
                       encoder=tte.load_trained_encoder(ENCODER_DIR))
    set_action_interface(te, "BDQ", cfg)
    tb = tenv.BatchedGraspEnv(te, B, torch.Generator().manual_seed(0))
    ts = tenv.env_state_from_numpy(_flat(js))
    with torch.no_grad():
        t_stepped, tr, tstatus = tb.step_core(ts, torch.as_tensor(bins))
        cur = tb.init_curriculum()
        _, tobs, tr2, tdone, tinfo, _ = tb.step(ts, torch.as_tensor(bins), cur)
    return dict(je=je, te=te, jstepped=_flat(stepped), jr=np.asarray(jr),
                jstatus=np.asarray(jstatus), jr2=np.asarray(jr2), jdone=np.asarray(jdone),
                jinfo_status=np.asarray(jinfo["status"]), jobs=_pallas_obs(je, nxt),
                tstepped=tenv.env_state_to_numpy(t_stepped), tr=tr.numpy(),
                tstatus=tstatus.numpy(), tr2=tr2.numpy(), tdone=tdone.numpy(),
                tinfo_status=tinfo["status"].numpy(), tobs=tobs.numpy())


def test_simplified_step_core_matches_jax(simplified_step):
    r = simplified_step
    np.testing.assert_array_equal(r["tstatus"], r["jstatus"])
    np.testing.assert_array_equal(r["tr"], r["jr"])
    # envs 0 and 1 made their grasp attempt (SUCCESS or FAIL), 2 and 3 descend
    assert set(r["jstatus"][:2]) <= {trew.SUCCESS, trew.FAIL}
    assert list(r["jstatus"][2:]) == [trew.RUNNING] * 2
    for key in ("gripper.q", "gripper.qd", "gripper.target", "objects.pos", "objects.quat"):
        np.testing.assert_allclose(r["tstepped"][key], r["jstepped"][key], atol=1e-4, rtol=0,
                                   err_msg=key)
    for key in ("gripper.finger_target", "gripper.gripper_close", "reward_state.old_height"):
        np.testing.assert_array_equal(r["tstepped"][key], r["jstepped"][key], err_msg=key)
    # the triggered envs closed and lifted: their z target is 5 cm up
    q, target = r["jstepped"]["gripper.q"], r["jstepped"]["gripper.target"]
    assert (r["jstepped"]["gripper.gripper_close"] == [True, True, False, False]).all()
    assert (target[:2, 2] > 0.1).all() and (np.abs(target[2:, 2] - 0.295) < 1e-6).all()
    assert (q[2:, 2] < 0.3 - 1e-3).all()  # the descent moved the grippers that go on


def test_simplified_step_matches_jax(simplified_step):
    r = simplified_step
    np.testing.assert_array_equal(r["tdone"], r["jdone"])
    np.testing.assert_array_equal(r["tr2"], r["jr2"])
    np.testing.assert_array_equal(r["tinfo_status"], r["jinfo_status"])
    assert list(r["tdone"]) == [True, True, False, False]
    assert r["te"].obs_shape == r["je"].obs_shape == r["tobs"].shape[1:] == (100,)
    np.testing.assert_allclose(r["tobs"][2:], r["jobs"][2:], atol=3e-2, rtol=0)
    assert np.abs(r["jobs"][2:]).max() > 0.5 and np.isfinite(r["tobs"]).all()


# ------------------------------------------------------------------ (d)

Q_TOL = 2e-2


def _flax_bundle_params(bundle, module, obs_dim):
    template = module.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim)))["params"]
    from deep_rl_grasping_tpu.algos import normalize as jnorm

    params, *_ = jpolicy_io.load_policy(bundle, template, jnorm.RunningMeanStd.init((obs_dim,)),
                                        jnorm.RunningMeanStd.init(()))
    return params


def _greedy_agree(q_t, q_f):
    """Greedy actions equal wherever the top two Q values are further apart
    than twice the largest |q_t - q_f|, and on 95% of all rows; returns the
    number of rows held exactly."""
    top2 = np.sort(q_f, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * np.abs(q_t - q_f).max()
    np.testing.assert_array_equal(q_t.argmax(-1)[clear], q_f.argmax(-1)[clear])
    assert (q_t.argmax(-1) == q_f.argmax(-1)).mean() >= 0.95
    return int(clear.sum())


def _latents(n=64):
    """n random latents and the 8 latents of the JAX validation scenes'
    first observations."""
    real = np.load(os.path.join(REPO, "deep_rl_grasping_tpu_torch", "data",
                                "simplified_r5_val_scenes.npz"))["obs"]
    rand = np.random.default_rng(5).normal(0.3, 0.5, (n, 100)).astype(np.float32)
    return np.concatenate([rand, real])


def test_dqn_bundle_network_matches_flax():
    config, learner, norm = ttrain.load_bundle_actor(DQN_BUNDLE, "cpu")
    assert isinstance(learner, DQN) and learner.num_actions == 12 and not config["normalize"]
    assert norm.obs_rms.mean.shape == (100,)  # carried, not applied (normalize: false)
    fq = jnet.QNetwork(12, (256, 256), False, True)
    params = _flax_bundle_params(DQN_BUNDLE, fq, 100)
    obs = _latents()
    q_f = np.asarray(fq.apply({"params": params}, jnp.asarray(obs)))
    with torch.no_grad():
        q_t = learner.net(torch.as_tensor(obs)).numpy()
    assert q_t.shape == q_f.shape == (72, 12)
    np.testing.assert_allclose(q_t, q_f, atol=Q_TOL, rtol=0)
    assert _greedy_agree(q_t, q_f) > 0 and np.ptp(q_f) > 0.1
    acts = learner.act(torch.as_tensor(obs), torch.Generator(), 0.0)
    assert acts.dtype == torch.int32 and torch.equal(acts.long(), torch.as_tensor(q_t).argmax(-1))


def test_bdq_bundle_network_matches_flax():
    _, learner, _ = ttrain.load_bundle_actor(BDQ_BUNDLE, "cpu")
    assert isinstance(learner, BDQ) and learner.num_actions_pad == 8
    fq = jnet.BDQNetwork(3, 8, (64, 64), (32,), (32,))
    params = _flax_bundle_params(BDQ_BUNDLE, fq, 100)
    obs = _latents()
    q_f = np.asarray(fq.apply({"params": params}, jnp.asarray(obs)))
    with torch.no_grad():
        q_t = learner.net(torch.as_tensor(obs)).numpy()
    assert q_t.shape == q_f.shape == (72, 3, 8)
    np.testing.assert_allclose(q_t, q_f, atol=Q_TOL, rtol=0)
    assert _greedy_agree(q_t, q_f) > 0
    # the value and the branch MLPs have the same shapes: loading them in
    # the wrong order still loads, and gives other Q values
    swapped = dict(params, MLP_1=params["MLP_2"], MLP_2=params["MLP_1"])
    net = tnet.BDQNetwork((100,), 3, 8)
    net.load_state_dict(policy_io.q_state_dict(_np_tree(swapped), net))
    with torch.no_grad():
        assert np.abs(net(torch.as_tensor(obs)).numpy() - q_f).max() > 10 * Q_TOL


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_bundle_loader_refuses_foreign_arrays(tmp_path):
    data = dict(np.load(os.path.join(DQN_BUNDLE, "policy.npz")))
    data["policy['Dense_4']['bias']"] = np.zeros(3, np.float32)
    np.savez(tmp_path / "policy.npz", **data)
    with pytest.raises(ValueError, match="policy arrays"):
        policy_io.load_policy(str(tmp_path), tnet.QNetwork((100,), 12, (256, 256)))
    with pytest.raises(ValueError, match="not a BDQ bundle"):
        policy_io.load_policy(DQN_BUNDLE, tnet.BDQNetwork((100,), 3, 8))


# ------------------------------------------------------------------ (e)

@pytest.fixture
def float32_networks(monkeypatch):
    monkeypatch.setattr(jnet, "CDTYPE", jnp.float32)
    monkeypatch.setattr(tnet, "CDTYPE", torch.float32)


def _q_batch(n, obs_dim, action):
    rng = np.random.default_rng(11)
    done = rng.random(n) < 0.3
    return dict(obs=rng.normal(size=(n, obs_dim)).astype(np.float32),
                next_obs=rng.normal(size=(n, obs_dim)).astype(np.float32),
                action=action, reward=rng.normal(0.0, 0.5, n).astype(np.float32), done=done,
                discount=(0.99 * ~done).astype(np.float32),
                weight=rng.uniform(0.1, 1.0, n).astype(np.float32))


QCASES = {
    "DQN": (lambda cfg: jdqn.DQN((12,), 6, cfg), lambda cfg: DQN((12,), 6, cfg, "cpu"),
            {"layers": [16, 16], "learning_rate": 1e-3}, ()),
    "BDQ": (lambda cfg: jbdq.BDQ((12,), 3, cfg), lambda cfg: BDQ((12,), 3, cfg, "cpu"),
            {"layers": [[16, 16], [8], [8]], "learning_rate": 1e-3, "num_actions_pad": 4}, (3,)),
}


@pytest.mark.parametrize("algo", list(QCASES))
@pytest.mark.parametrize("freq", [1, 2], ids=["target_copied", "target_kept"])
def test_q_update_matches_jax(float32_networks, algo, freq):
    make_j, make_t, block, act_shape = QCASES[algo]
    cfg = {"discount_factor": 0.99, algo: dict(block, target_network_update_freq=freq)}
    jalgo = make_j(cfg)
    state = jalgo.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(12)
    # a target network of its own
    state = state.replace(target_params=jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), state.params))
    n_act = 6 if algo == "DQN" else 4
    batch = _q_batch(16, 12, rng.integers(0, n_act, (16,) + act_shape).astype(np.int32))
    new, jm, jtd = jax.jit(jalgo.update)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    talgo = policy_io.load_q_state(make_t(cfg), _np(state.params), _np(state.target_params))
    tm, ttd = talgo.update({k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), rtol=1e-5, atol=1e-6)
    assert ttd.shape == (16,) and talgo.step == 1 and float(jm["loss"]) > 0
    lr = block["learning_rate"]
    sd = lambda p: policy_io.q_state_dict(_np(p), talgo.net)
    got, ref = talgo.net.state_dict(), sd(new.params)
    diffs = np.concatenate([(got[k] - ref[k]).abs().reshape(-1).numpy() for k in ref])
    assert diffs.max() <= 2 * lr + 1e-6 and (diffs > 1e-6).mean() <= 5e-3
    moved = np.concatenate([(got[k] - sd(state.params)[k]).abs().reshape(-1).numpy()
                            for k in ref])
    assert (moved > 0.5 * lr).mean() > 0.5
    # the target follows the params on an update-frequency step only
    want = new.params if freq == 1 else state.target_params
    for k, v in sd(new.target_params).items():
        np.testing.assert_array_equal(v.numpy(), sd(want)[k].numpy(), err_msg=k)
        assert torch.equal(talgo.target_net.state_dict()[k], got[k] if freq == 1 else v), k


# ------------------------------------------------------------------ (f)

OBS, STRIDE = (3,), 4


def _prioritized_buffers(n_batches=11, capacity=32, act_shape=(3,)):
    """Both buffers after the same inserts and priority updates; the ring
    wraps (n_batches x STRIDE > capacity)."""
    rng = np.random.default_rng(13)
    jb = jreplay.create(capacity, OBS, act_shape, STRIDE, action_dtype=jnp.int32)
    tb = treplay.create(capacity, OBS, act_shape, STRIDE, action_dtype=torch.int32)
    for i in range(n_batches):
        obs = rng.normal(size=(STRIDE,) + OBS).astype(np.float32)
        act = rng.integers(0, 8, (STRIDE,) + act_shape).astype(np.int32)
        rew = rng.normal(size=STRIDE).astype(np.float32)
        done = rng.random(STRIDE) < 0.25
        jb = jreplay.insert(jb, jnp.asarray(obs), jnp.asarray(act), jnp.asarray(rew),
                            jnp.asarray(done))
        treplay.insert(tb, torch.as_tensor(obs), torch.as_tensor(act), torch.as_tensor(rew),
                       torch.as_tensor(done))
        if i % 3 == 2:  # priorities from updates, some above the inserts' max
            idx = rng.choice(min((i + 1) * STRIDE, capacity), 5, replace=False).astype(np.int32)
            td = rng.uniform(0.0, 3.0, 5).astype(np.float32)
            jb = jreplay.update_priorities(jb, jnp.asarray(idx), jnp.asarray(td))
            treplay.update_priorities(tb, torch.as_tensor(idx, dtype=torch.int64),
                                      torch.as_tensor(td))
    return jb, tb


def test_prioritized_inserts_and_updates_match_jax():
    jb, tb = _prioritized_buffers()
    assert (tb.ptr, tb.size, tb.capacity) == (int(jb.ptr), int(jb.size), jb.capacity)
    np.testing.assert_array_equal(tb.priority.numpy(), np.asarray(jb.priority))
    np.testing.assert_array_equal(tb.action.numpy(), np.asarray(jb.action))
    assert tb.action.dtype == torch.int32
    p = tb.priority.numpy()
    assert len(set(p.tolist())) > 5 and p.max() > 1.0
    # the newest batch entered at the ring's largest priority before it
    newest = (tb.ptr - STRIDE) % tb.capacity
    assert (p[newest:newest + STRIDE] == p[newest:newest + STRIDE][0]).all()


def test_prioritized_weights_and_probabilities_match_jax():
    jb, tb = _prioritized_buffers()
    alpha, beta = 0.6, 0.4
    key = jax.random.PRNGKey(4)
    jbatch = jreplay.sample_prioritized(jb, key, 24, alpha, beta, n_step=2, gamma=0.9)
    idx = torch.as_tensor(np.asarray(jbatch["idx"]), dtype=torch.int64)
    w, probs = treplay.importance_weights(tb, idx, alpha, beta, n_step=2)
    np.testing.assert_allclose(w.numpy(), np.asarray(jbatch["weight"]), rtol=1e-6)
    # the distribution JAX's categorical draws from, in ring order
    n = int(jreplay._valid_range(jb, 2))
    slots = np.arange(jb.capacity)
    ring = (int(jb.ptr) - int(jb.size) + slots) % jb.capacity
    logits = np.where(slots < n, alpha * np.log(np.maximum(np.asarray(jb.priority)[ring],
                                                           1e-12)), -np.inf)
    want = np.zeros(jb.capacity, np.float32)
    want[ring] = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32)))
    got = treplay.probabilities(tb, alpha, n_step=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(probs.numpy(), want[idx.numpy()], rtol=1e-5)
    assert (got == 0).sum() == jb.capacity - n
    # the rows gathered for JAX's draws
    offs = torch.remainder(idx - (tb.ptr - tb.size), tb.capacity)
    tbatch = treplay.gather(tb, offs, n_step=2, gamma=0.9)
    for k in ("obs", "action", "reward", "done", "discount", "next_obs", "idx"):
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)


def test_prioritized_sampling_frequencies():
    jb, tb = _prioritized_buffers()
    probs = treplay.probabilities(tb, 0.6).numpy()
    draws = treplay.sample_prioritized(tb, torch.Generator().manual_seed(1), 40_000, 0.6, 0.4)
    counts = np.bincount(draws["idx"].numpy(), minlength=tb.capacity)
    live = probs > 0
    assert counts[~live].sum() == 0  # rows without a successor are never drawn
    expected = probs[live] * counts.sum()
    chi2 = ((counts[live] - expected) ** 2 / expected).sum()
    assert chi2 < stats.chi2.ppf(0.999, live.sum() - 1), chi2
    assert draws["weight"].max() == 1.0 and draws["weight"].min() > 0


# ------------------------------------------------------------------ (g)

@pytest.mark.parametrize("algo", ["DQN", "BDQ"])
def test_trainer_iteration(algo):
    cfg = jcfg.load_config(os.path.join(REPO, "configs", f"{algo.lower()}_simplified.yaml"))
    cfg["robot"]["discrete"] = True
    cfg["algorithm"] = algo.lower()
    cfg["tpu"].update(num_envs=2, max_objects=2, move_substeps=1, gripper_substeps=2,
                      solver_iterations=1, pad_inner_iterations=1, updates_per_step=2,
                      demo_frames=4)
    cfg[algo].update(batch_size=4, buffer_size=16, learning_starts=4, layers=(
        [[16], [8], [8]] if algo == "BDQ" else [16, 16]))
    cfg["time_horizon"] = 2
    trainer = Trainer(cfg, algo=algo, device="cpu", seed=1)
    assert trainer.prioritized and trainer.env.obs_shape == (100,)
    if algo == "BDQ":
        assert trainer.env.branched_actions and trainer.env.actuator_spec.num_actions_pad == 8
    state = trainer.init_state()
    state, n_done, _ = trainer.seed_demos(state, 4)
    assert state.buffer.size == 4
    for _ in range(3):
        state, metrics = trainer.train_step(state)
    buf = state.buffer
    assert buf.size == 10 and trainer.algo.step >= 2
    assert buf.action.dtype == torch.int32
    assert buf.action.shape == ((16, 3) if algo == "BDQ" else (16,))
    assert int(buf.action.max()) < (8 if algo == "BDQ" else 12) and int(buf.action.min()) >= 0
    assert (buf.priority[:buf.size] != 1.0).any()  # the updates wrote |TD| back
    assert all(np.isfinite(float(metrics[k])) for k in ("loss", "td_abs"))
    # epsilon anneals over env frames
    assert trainer.algo.epsilon(0) == 1.0 and trainer.algo.epsilon(10 ** 9) == pytest.approx(
        cfg[algo]["exploration_final_eps"])
    # the evaluation env decodes with the same action interface
    res = trainer.evaluate(trainer.policy, state.normalizer, n_episodes=2)
    assert res["episodes"] == 2 and np.isfinite(res["mean_return"])


def test_bdq_pad_override_reaches_every_env():
    cfg = step_config()
    te = tenv.GraspEnv(cfg, device="cpu", encoder=tte.load_trained_encoder(ENCODER_DIR))
    assert te.actuator_spec.num_actions_pad == 2 and not te.branched_actions
    set_action_interface(te, "BDQ", cfg)
    assert te.actuator_spec.num_actions_pad == 8 and te.branched_actions
    set_action_interface(te, "DQN", cfg)  # DQN keeps the robot's pads
    other = tenv.GraspEnv(cfg, device="cpu", encoder=te.encoder)
    assert set_action_interface(other, "DQN", cfg).actuator_spec.num_actions_pad == 2


# ------------------------------------------------------------------ (h)

def _contract_env(name):
    cfg = jcfg.load_config(CONFIGS[name])
    cfg["tpu"].update(max_objects=2, solver_iterations=1, pad_inner_iterations=1)
    enc = None
    if name == "encoder_simp":
        cfg["sensor"]["encoder_dir"] = "encoder_files/full_r4"
        enc = tte.load_trained_encoder(ENCODER_DIR)
    return tenv.GraspEnv(cfg, device="cpu", encoder=enc)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_env_contract(name):
    """Spaces, the first zero-action step's reward and the kinematics
    (tests/test_env_contract.py:46-158) at the configs' own schedules."""
    env = _contract_env(name)
    je = jenv.GraspEnv(jcfg.load_config(CONFIGS[name]))
    assert env.obs_shape == je.obs_shape
    if env.simplified and env.discrete:
        assert env.num_actions == 3 * 2
    elif env.simplified:
        assert env.action_dim == 3 and not env.discrete
    else:
        assert env.discrete and env.num_actions == 11
    assert env.obs_shape == {"simplified_cont": (64, 64, 2), "encoder_simp": (100,),
                             "discrete": (64, 64, 2)}[name]
    benv = tenv.BatchedGraspEnv(env, 2, torch.Generator().manual_seed(0))
    cur = benv.init_curriculum()
    zero = torch.zeros(2, dtype=torch.int64) if env.discrete else torch.zeros(2, 3)
    with torch.no_grad():
        states, obs = benv.reset(cur)
        z0 = states.sim.gripper.q[:, 2].clone()
        stepped, obs2, reward, done, _, _ = benv.step(states, zero, cur)
    assert obs.shape == obs2.shape == (2,) + env.obs_shape and np.isfinite(obs2.numpy()).all()
    assert not done.any()
    dz = (stepped.sim.gripper.q[:, 2] - z0).numpy()
    if env.simplified:
        assert reward.tolist() == [0.0, 0.0]
        np.testing.assert_allclose(dz, -0.005, atol=1e-3)
        if env.image_obs:  # the padding channel carries nothing
            assert float(obs2[..., 1].abs().max()) == 0.0
    else:
        assert reward.tolist() == [-11.0, -11.0]
        np.testing.assert_allclose(dz, 0.0, atol=1e-3)
        with torch.no_grad():  # the last action index closes the gripper
            closed, *_ = benv.step(stepped, torch.full((2,), env.num_actions - 1), cur)
        assert bool(closed.sim.gripper.gripper_close.all())
