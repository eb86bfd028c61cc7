"""PPO, TRPO and the on-policy trainer in the port vs the JAX package, on
the CPU at a small size (encoder-latent rows 101 wide, [64, 64] towers).

(a) `ActorCritic`: the port module's Flax layout (`policy_io.layout`)
    gives exactly the key paths and shapes of a Flax `init`, for the MLP
    towers (continuous and discrete) and a tiny image torso; fed the Flax
    params, its outputs (logits or mean, log_std, value) agree with the
    Flax module's at bf16 tolerance (5e-2 absolute + relative: both
    compute the towers in bfloat16 and round at other places).
(b) The log-probability and entropy of given actions, and `act` with the
    JAX package's draws handed in (its normal noise; for discrete actions
    the Gumbel noise `jax.random.categorical` adds), deterministic and
    not: 1e-5, the networks in float32 on both sides (CDTYPE patched in
    both packages, as tests/test_torch_algos.py does for SAC).
(c) `gae` on a (T = 8, B = 4) rollout with dones, PPO's lambda and
    TRPO's: 1e-5 relative.
(d) One PPO minibatch update, continuous and discrete, float32 networks,
    from the same params and batch: loss, pg / vf / entropy to 1e-5
    relative; the global-norm clip active (the gradient's norm above
    0.5); Adam's moments to 1e-5 of their scale; the updated params to
    1e-6 on all but 0.5% of them and to 2 x the learning rate everywhere
    (Adam's first step can flip sign on a gradient within rounding of
    zero).
(e) One TRPO update, continuous and discrete, float32 networks: the
    surrogate, the KL, `line_search_ok`, the params after the line search
    (`vf_iters` 0) and after the value fit (3 Adam steps), and the value
    Adam's moments, zero on the policy's parameters: 1e-4 (ten rounds of
    conjugate gradient in another summation order).
(f) `OnPolicyTrainer.train_iteration` on the simplified PPO and TRPO
    configs cut to 4 envs and 4 steps: it counts n_steps x B frames, fills
    the monitor ring with the rollout's finished episodes, moves the
    params, and its advantages, returns and flattened batch equal JAX
    `PPO.gae` applied to its own recorded trajectory (1e-6). No JAX env is
    built.
(g) Bundles: one written by the JAX package's `save_policy` for a PPO and
    a TRPO `ActorCritic` loads into the port and gives the Flax module's
    deterministic actions (bf16 tolerance, as (a)); one the port writes
    loads through the JAX `load_policy` into the very same arrays.
(h) `train`, then `train --load_dir` with no further frame, for PPO and
    TRPO at tiny width: the resumed run writes back exactly what it
    restored (params, Adam moments and counts, update count, normalizer
    moments, curriculum, frames); `run --model` and `tools/export_policy`
    + `run --npz` of the run evaluate it, the JAX loader reads the export.
    The committed `trained/{ppo,trpo,ddpg}_simplified_torch_r1` bundles,
    read and written back, come out bit for bit.

TF32 is off (`train.set_precision()`); it would only matter on a GPU.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu.algos import normalize as jnorm
from deep_rl_grasping_tpu.algos import ppo as jppo
from deep_rl_grasping_tpu.algos import trpo as jtrpo
from deep_rl_grasping_tpu.models import networks as jnet
from deep_rl_grasping_tpu.utils import policy_io as jpolicy_io
from deep_rl_grasping_tpu_torch.algos import normalize as tnorm
from deep_rl_grasping_tpu_torch.algos import ppo as tppo
from deep_rl_grasping_tpu_torch.algos import trpo as ttrpo
from deep_rl_grasping_tpu_torch.models import networks as tnet
from deep_rl_grasping_tpu_torch.tools import export_policy
from deep_rl_grasping_tpu_torch.training import callbacks as cb
from deep_rl_grasping_tpu_torch.training import train
from deep_rl_grasping_tpu_torch.training.onpolicy import OnPolicyTrainer
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils, policy_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS, A, N = (101,), 3, 32
BF16_TOL = 5e-2


@pytest.fixture(scope="module", autouse=True)
def _precision():
    train.set_precision()
    assert not torch.backends.cuda.matmul.allow_tf32
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def float32_networks(monkeypatch):
    monkeypatch.setattr(jnet, "CDTYPE", jnp.float32)
    monkeypatch.setattr(tnet, "CDTYPE", torch.float32)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _cfg(**block):
    layers = [64, 64]
    return {"discount_factor": 0.99,
            "PPO": dict(dict(layers=layers, learning_rate=1e-3, n_steps=8), **block),
            "TRPO": dict(dict(layers=layers, step_size=1e-3, n_steps=8), **block)}


def _jitter(params, rng, scale=0.05):
    """Params moved off the init, log_std included."""
    return jax.tree.map(lambda p: p + scale * rng.standard_normal(p.shape).astype(np.float32),
                        params)


@functools.lru_cache(maxsize=None)
def _init_params(discrete, obs_shape):
    """Flax `ActorCritic` params moved off the init, built once per shape
    (PPO's and TRPO's networks are the same module)."""
    net = jppo.ActorCritic(5 if discrete else A, discrete, tuple(_cfg()["PPO"]["layers"]))
    params = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1,) + obs_shape))["params"]
    return _jitter(params, np.random.default_rng(1))


def _pair(kind, discrete, obs_shape=OBS, **block):
    """(JAX learner, its params moved off init, port learner with them)."""
    jcls, tcls = {"PPO": (jppo.PPO, tppo.PPO), "TRPO": (jtrpo.TRPO, ttrpo.TRPO)}[kind]
    cfg = _cfg(**block)
    n = 5 if discrete else A
    jalgo = jcls(obs_shape, n, cfg, discrete=discrete)
    params = _init_params(discrete, obs_shape)
    talgo = tcls(obs_shape, n, cfg, discrete=discrete)
    policy_io.load_flax_params(talgo.net, _np(params))
    return jalgo, params, talgo


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ------------------------------------------------------------------ (a)

NETS = [("continuous", False, OBS), ("discrete", True, OBS), ("image", False, (36, 36, 3))]


@pytest.mark.parametrize("name,discrete,obs_shape", NETS, ids=[n[0] for n in NETS])
def test_actor_critic_matches_flax(name, discrete, obs_shape):
    n = 5 if discrete else A
    fnet = jppo.ActorCritic(n, discrete, (16, 16), len(obs_shape) == 3)
    params = _jitter(jax.jit(fnet.init)(jax.random.PRNGKey(0), jnp.zeros((1,) + obs_shape))[
        "params"], np.random.default_rng(2))
    net = tppo.ActorCritic(obs_shape, n, discrete, (16, 16), len(obs_shape) == 3)
    # the layout's key paths and shapes are those of the Flax init
    mine = {k: v.shape for k, v in _leaves(policy_io.flax_params(net.state_dict(), net)).items()}
    assert mine == {k: v.shape for k, v in _leaves(_np(params)).items()}
    policy_io.load_flax_params(net, _np(params))
    obs = np.random.default_rng(3).normal(size=(24,) + obs_shape).astype(np.float32)
    f_out, f_log_std, f_val = jax.jit(fnet.apply)({"params": params}, jnp.asarray(obs))
    with torch.no_grad():
        t_out, t_log_std, t_val = net(torch.as_tensor(obs))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(f_out), atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(t_val.numpy(), np.asarray(f_val), atol=BF16_TOL, rtol=BF16_TOL)
    assert np.ptp(np.asarray(f_out)) > 0.1 and np.ptp(np.asarray(f_val)) > 0.1
    if discrete:
        assert t_log_std is None and f_log_std is None
    else:
        np.testing.assert_array_equal(t_log_std.detach().numpy(), np.asarray(f_log_std))


# ------------------------------------------------------------------ (b)

@pytest.mark.parametrize("discrete", [False, True], ids=["continuous", "discrete"])
def test_logp_entropy_and_act_match_jax(float32_networks, discrete):
    jalgo, params, talgo = _pair("PPO", discrete)
    rng = np.random.default_rng(4)
    obs = rng.normal(size=(N,) + OBS).astype(np.float32)
    out, log_std, _ = jax.jit(jalgo.net.apply)({"params": params}, jnp.asarray(obs))
    if discrete:
        action = rng.integers(0, 5, N).astype(np.int32)
    else:
        action = rng.uniform(-1, 1, (N, A)).astype(np.float32)
    jl, je = jax.jit(jalgo._logp_entropy)(out, log_std, jnp.asarray(action))
    tl, te = talgo.logp_entropy(torch.as_tensor(np.asarray(out)),
                                None if discrete else torch.as_tensor(np.asarray(log_std)),
                                torch.as_tensor(action))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-5)

    key = jax.random.PRNGKey(5)
    draw = jax.random.gumbel if discrete else jax.random.normal
    noise = torch.as_tensor(np.asarray(draw(key, (N, 5 if discrete else A))))
    obs_t = torch.as_tensor(obs)
    jact = jax.jit(jalgo.act, static_argnums=3)
    for det in (False, True):
        ja, jlp, jv = jact(params, jnp.asarray(obs), key, det)
        ta, tlp, tv = talgo.act(obs_t, noise=None if det else noise, deterministic=det)
        if discrete:
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        else:
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    if not discrete:  # some draws reached the clip: their logp is the clipped action's
        ja, _, _ = jact(params, jnp.asarray(obs), key, False)
        assert (np.abs(np.asarray(ja)) == 1.0).any()


# ------------------------------------------------------------------ (c)

@pytest.mark.parametrize("kind", ["PPO", "TRPO"])
def test_gae_matches_jax(kind):
    jalgo, _, talgo = _pair(kind, False)
    rng = np.random.default_rng(6)
    T, B = 8, 4
    r = rng.normal(size=(T, B)).astype(np.float32)
    v = rng.normal(size=(T, B)).astype(np.float32)
    d = rng.random((T, B)) < 0.25
    last = rng.normal(size=B).astype(np.float32)
    assert d.any() and talgo.gae_lambda == jalgo.gae_lambda
    ja, jr = jalgo.gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), jnp.asarray(last))
    ta, tr = talgo.gae(*(torch.as_tensor(x) for x in (r, v, d, last)))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ (d)

def _batch(jalgo, params, discrete, seed=7):
    """A rollout batch whose logp and value come from the old policy, a
    little perturbed, so that ratios and value clips take both branches."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(N,) + OBS).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    action, logp, value = jax.jit(jalgo.act, static_argnums=3)(params, jnp.asarray(obs), key,
                                                               False)
    return dict(obs=obs, action=np.asarray(action),
                logp=np.asarray(logp) + rng.normal(0, 0.3, N).astype(np.float32),
                value=np.asarray(value) + rng.normal(0, 0.3, N).astype(np.float32),
                advantage=rng.normal(0.5, 1.0, N).astype(np.float32),
                **{"return": rng.normal(0, 1.0, N).astype(np.float32)})


def _adam_state(opt, net, field):
    """An Adam moment of every parameter, in the Flax layout."""
    sd = {k: opt.state[p][field] for k, p in net.named_parameters()}
    return _leaves(policy_io.flax_params(sd, net))


def _assert_params(net, jparams, lr, where):
    want = _leaves(_np(jparams))
    got = _leaves(policy_io.flax_params(net.state_dict(), net))
    diffs = np.concatenate([np.abs(got[k] - want[k]).reshape(-1) for k in want])
    assert diffs.max() <= 2 * lr + 1e-6, where
    assert (diffs > 1e-6).mean() <= 5e-3, where


@pytest.mark.parametrize("discrete", [False, True], ids=["continuous", "discrete"])
def test_ppo_update_matches_jax(float32_networks, discrete):
    jalgo, params, talgo = _pair("PPO", discrete)
    state = jppo.PPOState(params=params, opt_state=jalgo.tx.init(params),
                          step=jnp.asarray(0, jnp.int32))
    batch = _batch(jalgo, params, discrete)
    new_state, jm = jax.jit(jalgo.update)(state, {k: jnp.asarray(v) for k, v in batch.items()},
                                          None)
    tm = talgo.update({k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("loss", "pg_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(tm["grad_norm"]) > tppo.GRAD_CLIP  # the clip scaled this step
    assert talgo.step == 1 and int(new_state.step) == 1
    adam = new_state.opt_state[1][0]
    for field, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want, got = _leaves(_np(tree)), _adam_state(talgo.opt, talgo.net, field)
        scale = max(np.abs(w).max() for w in want.values())
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5 * scale, rtol=0,
                                       err_msg=field + k)
    _assert_params(talgo.net, new_state.params, 1e-3, "params")


# ------------------------------------------------------------------ (e)

@pytest.mark.parametrize("discrete,vf_iters", [(False, 0), (False, 3), (True, 3)],
                         ids=["continuous_line_search", "continuous_vf_fit", "discrete_vf_fit"])
def test_trpo_update_matches_jax(float32_networks, discrete, vf_iters):
    jalgo, params, talgo = _pair("TRPO", discrete, vf_iters=vf_iters)
    state = jtrpo.TRPOState(params=params, vf_opt=jalgo.vf_tx.init(params),
                            step=jnp.asarray(0, jnp.int32))
    batch = _batch(jalgo, params, discrete, seed=8)
    new_state, jm = jax.jit(jalgo.update)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = talgo.update({k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(jm["line_search_ok"]) == float(tm["line_search_ok"]) == 1.0
    for k in ("surrogate", "kl", "vf_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert 0 < float(jm["kl"]) <= 1.5 * jalgo.max_kl
    want = _leaves(_np(new_state.params))
    got = _leaves(policy_io.flax_params(talgo.net.state_dict(), talgo.net))
    before = _leaves(_np(params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4, err_msg=k)
    moved = [k for k in want if np.abs(want[k] - before[k]).max() > 1e-5]
    policy = [k for k in want if k.startswith(("/MLP_0", "/Dense_0", "/log_std"))]
    assert set(policy) <= set(moved)  # the natural-gradient step moved the policy
    value = [k for k in want if k.startswith(("/MLP_1", "/Dense_1"))]
    assert bool(set(value) & set(moved)) == (vf_iters > 0)
    if vf_iters:
        adam = new_state.vf_opt[0]
        for field, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            w, g = _leaves(_np(tree)), _adam_state(talgo.opt, talgo.net, field)
            scale = max(np.abs(x).max() for x in w.values())
            for k in w:
                np.testing.assert_allclose(g[k], w[k], atol=1e-4 * scale, rtol=0)
                if k in policy:  # the value fit's Adam leaves the policy alone
                    assert not g[k].any() and not w[k].any()


# ------------------------------------------------------------------ (f)

def _tiny_config(algo, n_envs=4, n_steps=4):
    cfg = cfg_util.load_config(os.path.join(REPO, "configs", f"{algo.lower()}_simplified.yaml"))
    cfg["tpu"].update(num_envs=n_envs, max_objects=2, move_substeps=1, gripper_substeps=2,
                      solver_iterations=1, pad_inner_iterations=1)
    cfg[algo].update(n_steps=n_steps, layers=[16, 16])
    if algo == "PPO":
        cfg[algo].update(n_minibatches=2, n_epochs=2)
    else:
        cfg[algo].update(cg_iters=3, vf_iters=2)
    cfg["time_horizon"] = 3
    cfg["algorithm"] = algo.lower()
    return cfg


@pytest.mark.parametrize("algo", ["PPO", "TRPO"])
def test_trainer_iteration_and_gae(algo):
    tr = OnPolicyTrainer(_tiny_config(algo), algo=algo, device="cpu", seed=3)
    assert tr.frames_per_iteration == 16 and tr.normalize
    state = tr.init_state()
    before = [p.detach().clone() for p in tr.algo.net.parameters()]
    state, metrics = tr.train_chunk(state, 1)
    assert state.global_step == 16 and tr.algo.step == (4 if algo == "PPO" else 1)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(a, b) for a, b in zip(before, tr.algo.net.parameters()))
    traj, batch = tr.rollout["traj"], tr.rollout["batch"]
    assert traj["obs"].shape == (4, 4, 100) and batch["obs"].shape == (16, 100)
    dones = traj["done"]
    assert bool(dones.any()) and int(state.ep_ring_n) == int(dones.sum())
    # the normalizer folded every step in
    assert float(state.normalizer.obs_rms.count) == pytest.approx(1e-4 + 16)
    # GAE as the JAX package computes it on this very trajectory
    jalgo = (jppo.PPO if algo == "PPO" else jtrpo.TRPO)((100,), 3, tr.config)
    ja, jr = jalgo.gae(*(jnp.asarray(traj[k].numpy()) for k in ("reward", "value", "done")),
                       jnp.asarray(tr.rollout["last_value"].numpy()))
    np.testing.assert_allclose(batch["advantage"].numpy(), np.asarray(ja).reshape(-1),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(batch["return"].numpy(), np.asarray(jr).reshape(-1),
                               rtol=1e-6, atol=1e-6)
    for k in ("obs", "action", "logp", "value"):
        assert torch.equal(batch[k], traj[k].reshape(batch[k].shape)), k


# ------------------------------------------------------------------ (g)

def _rms(shape, rng):
    return jnorm.RunningMeanStd(mean=jnp.asarray(rng.normal(size=shape), jnp.float32),
                                var=jnp.asarray(rng.uniform(0.5, 2, shape), jnp.float32),
                                count=jnp.asarray(123.0, jnp.float32))


@pytest.mark.parametrize("kind", ["PPO", "TRPO"])
def test_bundles_cross_both_ways(kind, tmp_path):
    jalgo, params, talgo = _pair(kind, False)
    rng = np.random.default_rng(10)
    obs_rms, ret_rms = _rms(OBS, rng), _rms((), rng)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpolicy_io.save_policy(jdir, params, obs_rms, ret_rms, {"algo": kind, "params_field": "params"})
    net = tppo.ActorCritic(OBS, A, False, (64, 64))
    _, norm, meta = policy_io.load_policy(jdir, net, algo=kind)
    assert meta["algo"] == kind
    np.testing.assert_array_equal(norm.obs_rms.var.numpy(), np.asarray(obs_rms.var))
    obs = rng.normal(size=(N,) + OBS).astype(np.float32)
    ja, _, _ = jalgo.act(params, jnp.asarray(obs), jax.random.PRNGKey(0), True)
    talgo.net = net
    ta, _, _ = talgo.act(torch.as_tensor(obs), deterministic=True)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=BF16_TOL, rtol=0)
    with pytest.raises(ValueError, match=f"not a {'TRPO' if kind == 'PPO' else 'PPO'} bundle"):
        policy_io.load_policy(jdir, tppo.ActorCritic(OBS, A, False, (64, 64)),
                              algo="TRPO" if kind == "PPO" else "PPO")

    # the port's export, read by the JAX loader into the same arrays
    tnorm_rms = tnorm.RunningMeanStd(mean=torch.zeros(OBS), var=torch.ones(OBS),
                                     count=torch.tensor(5.0))
    policy_io.save_policy(tdir, net, tnorm_rms, tnorm.RunningMeanStd.init(()), algo=kind)
    template = jax.tree.map(np.zeros_like, params)
    back, _, _, meta = jpolicy_io.load_policy(tdir, template, jnorm.RunningMeanStd.init(OBS),
                                              jnorm.RunningMeanStd.init(()))
    assert meta["algo"] == kind and meta["params_field"] == "params"
    for k, v in _leaves(_np(params)).items():
        np.testing.assert_array_equal(_leaves(_np(back))[k], v, err_msg=k)


# ------------------------------------------------------------------ (h)

def _equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("algo", ["PPO", "TRPO"])
def test_resume_round_trip_and_export(algo, tmp_path):
    cfg = _tiny_config(algo, n_envs=2, n_steps=2)
    cfg["tpu"].update(eval_freq=16, checkpoint_freq=4)
    cfg[algo]["total_timesteps"] = 8
    path = str(tmp_path / "cfg.yaml")
    io_utils.save_yaml(cfg, path)
    run = lambda name, *extra: train.main(
        ["train", "--config", path, "--algo", algo, "--model_dir", str(tmp_path / name),
         "--device", "cpu", "--seed", "2", *extra])
    first = run("a")
    assert first["frames"] == 8 and first["done"] and first["replay_rows"] is None
    assert first["updates"] == (2 * 2 if algo == "PPO" else 1) * 2
    again = run("c", "--load_dir", str(tmp_path / "a"))
    assert again["resume_frames"] == 8 and again["frames"] == 8
    saved = cb.Checkpointer(str(tmp_path / "a")).restore()
    _equal(cb.Checkpointer(str(tmp_path / "c")).restore(), saved)
    assert set(saved["algo_state"]) == {"net", "opt", "step"}
    opt = saved["algo_state"]["opt"]["state"]
    assert all(float(s["step"]) > 0 for s in opt.values())
    assert not os.path.exists(tmp_path / "a" / "ring")
    # evaluation of the checkpoint and of its export
    res = train.main(["run", "--model", str(tmp_path / "a"), "--episodes", "2",
                      "--device", "cpu"])
    out = str(tmp_path / "bundle")
    export_policy.main([str(tmp_path / "a"), "--out", out, "--latest", "--device", "cpu"])
    res_npz = train.main(["run", "--npz", out, "--episodes", "2", "--device", "cpu"])
    assert res_npz["episodes"] == res["episodes"] == 2
    assert res_npz["mean_return"] == res["mean_return"]
    shape = (100,)
    template = jppo.ActorCritic(A, False, (16, 16)).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + shape))["params"]
    back, jobs, _, meta = jpolicy_io.load_policy(out, template, jnorm.RunningMeanStd.init(shape),
                                                 jnorm.RunningMeanStd.init(()))
    assert meta["algo"] == algo
    _, policy, _ = train.load_checkpoint_actor(str(tmp_path / "a"), "cpu")
    for k, v in _leaves(policy_io.flax_params(policy.net.state_dict(), policy.net)).items():
        np.testing.assert_array_equal(_leaves(_np(back))[k], v, err_msg=k)
    np.testing.assert_array_equal(np.asarray(jobs.mean), saved["obs_rms"]["mean"].numpy())


@pytest.mark.parametrize("bundle", ["ppo_simplified_torch_r1", "trpo_simplified_torch_r1",
                                    "ddpg_simplified_torch_r1"])
def test_reexport_reproduces_the_committed_bundle(bundle, tmp_path):
    """The port's committed PPO, TRPO and DDPG bundles, read by `run`'s
    loader and written back by `save_policy`, come out bit for bit."""
    path = os.path.join(REPO, "trained", bundle)
    config, policy, norm = train.load_bundle_actor(path, "cpu")
    algo = config["algorithm"].upper()
    policy_io.save_policy(str(tmp_path), train.policy_net(policy), norm.obs_rms, norm.ret_rms,
                          algo=algo)
    want, got = np.load(os.path.join(path, "policy.npz")), np.load(tmp_path / "policy.npz")
    assert set(want.files) == set(got.files)
    for k in want.files:
        if k != "__meta__":
            assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    assert policy_io.read_bundle(str(tmp_path))[3]["algo"] == algo
