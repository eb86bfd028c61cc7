"""DDPG in the port vs the JAX package, on the CPU at a small size
(encoder-latent rows 101 wide, [64, 64] MLPs, a tiny image torso).

(a) `DeterministicActor` and `SingleCritic`: the port modules' Flax layout
    (`policy_io.layout`) gives exactly the key paths and shapes of a Flax
    `init`, on latents and on images; fed the Flax params, their outputs
    agree with the Flax modules' at bf16 tolerance (5e-2 absolute +
    relative: both compute the MLPs in bfloat16 and round at other
    places).
(b) `act` with the JAX package's normal draw handed in, and
    deterministically: 1e-5, the networks in float32 on both sides
    (CDTYPE patched in both packages, as tests/test_torch_algos.py does
    for SAC); some noisy actions reach the clip at +-1.
(c) One `DDPG.update` from the same actor, critic and target params and
    one batch with an n-step `discount` column and importance weights,
    float32 networks: both losses and |TD| per row to 1e-5 relative; the
    updated actor and critic to 1e-6 on all but 0.5% of their params and
    to 2 x the learning rate everywhere (Adam's first step can flip sign on
    a gradient within rounding of zero); the Polyak targets to 1e-6.
(d) Bundles: one written by the JAX package's `save_policy` for a DDPG
    actor loads into the port and gives the Flax actor's actions (bf16
    tolerance); one the port writes loads through the JAX `load_policy`
    into the very same arrays.
(e) `train` on configs/ddpg_simplified.yaml cut to 2 envs and 16 hidden
    units (scripted-expert demos, uniform replay, 2 updates per
    iteration), then `train --load_dir` with no further frame: the resumed
    run writes back exactly what it restored (actor, critic, both targets,
    both Adams' moments and counts, update count, normalizer, curriculum,
    frames) and the ring's rows; `tools/export_policy` + `run --npz`
    evaluate the run, and the JAX loader reads the export.

TF32 is off (`train.set_precision()`); it would only matter on a GPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu.algos import ddpg as jddpg
from deep_rl_grasping_tpu.algos import normalize as jnorm
from deep_rl_grasping_tpu.models import networks as jnet
from deep_rl_grasping_tpu.utils import policy_io as jpolicy_io
from deep_rl_grasping_tpu_torch.algos import ddpg as tddpg
from deep_rl_grasping_tpu_torch.algos import normalize as tnorm
from deep_rl_grasping_tpu_torch.models import networks as tnet
from deep_rl_grasping_tpu_torch.tools import export_policy
from deep_rl_grasping_tpu_torch.training import callbacks as cb
from deep_rl_grasping_tpu_torch.training import train
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils, policy_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS, A, N = (101,), 3, 32
BF16_TOL = 5e-2
CFG = {"discount_factor": 0.99,
       "DDPG": {"layers": [64, 64], "actor_lr": 1e-3, "critic_lr": 2e-3, "tau": 0.05,
                "noise_sigma": 0.3, "batch_size": N}}


@pytest.fixture(scope="module", autouse=True)
def _precision():
    train.set_precision()
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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _jitter(params, rng, scale=0.05):
    return jax.tree.map(lambda p: p + scale * rng.standard_normal(p.shape).astype(np.float32),
                        params)


def _flax(module):
    return _leaves(policy_io.flax_params(module.state_dict(), module))


def _pair(obs_shape=OBS):
    """(JAX DDPG, its state with every tree moved off init, port DDPG with
    the same params)."""
    jalgo = jddpg.DDPG(obs_shape, A, CFG)
    state = jax.jit(jalgo.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    state = state.replace(**{f: _jitter(getattr(state, f), rng) for f in (
        "actor_params", "critic_params", "target_actor_params", "target_critic_params")})
    talgo = tddpg.DDPG(obs_shape, A, CFG)
    for name, field in (("actor", "actor_params"), ("critic", "critic_params"),
                        ("target_actor", "target_actor_params"),
                        ("target_critic", "target_critic_params")):
        policy_io.load_flax_params(getattr(talgo, name), _np(getattr(state, field)))
    return jalgo, state, talgo


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("obs_shape", [OBS, (36, 36, 3)], ids=["latent", "image"])
def test_networks_match_flax(obs_shape):
    image = len(obs_shape) == 3
    rng = np.random.default_rng(2)
    obs = rng.normal(size=(24,) + obs_shape).astype(np.float32)
    action = rng.uniform(-1, 1, (24, A)).astype(np.float32)
    for fmod, tmod, args in (
            (jddpg.DeterministicActor(A, (16, 16), image),
             tddpg.DeterministicActor(obs_shape, A, (16, 16), image), (obs,)),
            (jddpg.SingleCritic((16, 16), image),
             tddpg.SingleCritic(obs_shape, A, (16, 16), image), (obs, action))):
        params = _jitter(jax.jit(fmod.init)(jax.random.PRNGKey(0),
                                            *(jnp.asarray(a[:1]) for a in args))["params"], rng)
        assert ({k: v.shape for k, v in _flax(tmod).items()}
                == {k: v.shape for k, v in _leaves(_np(params)).items()})
        policy_io.load_flax_params(tmod, _np(params))
        want = np.asarray(jax.jit(fmod.apply)({"params": params}, *map(jnp.asarray, args)))
        with torch.no_grad():
            got = tmod(*map(torch.as_tensor, args)).numpy()
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)
        assert np.ptp(want) > 0.05


# ------------------------------------------------------------------ (b)

def test_act_matches_jax(float32_networks):
    jalgo, state, talgo = _pair()
    obs = np.random.default_rng(3).normal(size=(N,) + OBS).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = torch.as_tensor(np.asarray(jax.random.normal(key, (N, A))))
    jact = jax.jit(jalgo.act, static_argnums=3)
    for det in (False, True):
        want = np.asarray(jact(state.actor_params, jnp.asarray(obs), key, det))
        got = talgo.act(torch.as_tensor(obs), noise=noise, deterministic=det).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        if not det:
            assert (np.abs(want) == 1.0).any()


# ------------------------------------------------------------------ (c)

def test_update_matches_jax(float32_networks):
    jalgo, state, talgo = _pair()
    rng = np.random.default_rng(5)
    done = rng.random(N) < 0.3
    batch = dict(obs=rng.normal(size=(N,) + OBS).astype(np.float32),
                 next_obs=rng.normal(size=(N,) + OBS).astype(np.float32),
                 action=rng.uniform(-1, 1, (N, A)).astype(np.float32),
                 reward=rng.normal(0, 0.5, N).astype(np.float32), done=done,
                 discount=(0.99 ** 3 * ~done).astype(np.float32),
                 weight=rng.uniform(0.2, 1.0, N).astype(np.float32))
    new, jm, jtd = jax.jit(jalgo.update)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    tm, ttd = talgo.update({k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("critic_loss", "actor_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), rtol=1e-5, atol=1e-6)
    assert talgo.step == 1 and int(new.step) == 1
    for name, field, lr in (("actor", "actor_params", 1e-3), ("critic", "critic_params", 2e-3)):
        want, got = _leaves(_np(getattr(new, field))), _flax(getattr(talgo, name))
        diffs = np.concatenate([np.abs(got[k] - want[k]).reshape(-1) for k in want])
        assert diffs.max() <= 2 * lr + 1e-6 and (diffs > 1e-6).mean() <= 5e-3, name
        before = _leaves(_np(getattr(state, field)))
        assert np.mean([np.abs(want[k] - before[k]).max() > 0.5 * lr for k in want]) > 0.5
    for name, field in (("target_actor", "target_actor_params"),
                        ("target_critic", "target_critic_params")):
        want, got = _leaves(_np(getattr(new, field))), _flax(getattr(talgo, name))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=name + k)


# ------------------------------------------------------------------ (d)

def test_bundles_cross_both_ways(tmp_path):
    jalgo, state, talgo = _pair()
    rng = np.random.default_rng(6)
    obs_rms = jnorm.RunningMeanStd(mean=jnp.asarray(rng.normal(size=OBS), jnp.float32),
                                   var=jnp.asarray(rng.uniform(0.5, 2, OBS), jnp.float32),
                                   count=jnp.asarray(7.0, jnp.float32))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpolicy_io.save_policy(jdir, state.actor_params, obs_rms, jnorm.RunningMeanStd.init(()),
                           {"algo": "DDPG", "params_field": "actor_params"})
    actor = tddpg.DeterministicActor(OBS, A, (64, 64))
    _, norm, meta = policy_io.load_policy(jdir, actor)
    assert meta["algo"] == "DDPG"
    np.testing.assert_array_equal(norm.obs_rms.mean.numpy(), np.asarray(obs_rms.mean))
    obs = rng.normal(size=(N,) + OBS).astype(np.float32)
    want = np.asarray(jalgo.actor.apply({"params": state.actor_params}, jnp.asarray(obs)))
    with torch.no_grad():
        np.testing.assert_allclose(actor(torch.as_tensor(obs)).numpy(), want, atol=BF16_TOL)

    policy_io.save_policy(tdir, actor, tnorm.RunningMeanStd.init(OBS),
                          tnorm.RunningMeanStd.init(()))
    template = jalgo.init(jax.random.PRNGKey(1)).actor_params
    back, _, _, meta = jpolicy_io.load_policy(tdir, template, jnorm.RunningMeanStd.init(OBS),
                                              jnorm.RunningMeanStd.init(()))
    assert meta["algo"] == "DDPG" and meta["params_field"] == "actor_params"
    for k, v in _leaves(_np(state.actor_params)).items():
        np.testing.assert_array_equal(_leaves(_np(back))[k], v, err_msg=k)


# ------------------------------------------------------------------ (e)

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


def test_train_resume_and_export(tmp_path):
    cfg = cfg_util.load_config(os.path.join(REPO, "configs", "ddpg_simplified.yaml"))
    cfg["tpu"].update(num_envs=2, max_objects=2, move_substeps=1, gripper_substeps=2,
                      solver_iterations=1, pad_inner_iterations=1, updates_per_step=2,
                      demo_frames=8, demo_refresh_every=0, eval_freq=32, checkpoint_freq=4,
                      chunk_steps=2, ring_checkpoint_rows=16, ring_checkpoint_every=12)
    cfg["DDPG"].update(batch_size=4, buffer_size=32, learning_starts=4, layers=[16, 16],
                       total_timesteps=16)
    cfg["time_horizon"] = 3
    cfg["algorithm"] = "ddpg"
    path = str(tmp_path / "cfg.yaml")
    io_utils.save_yaml(cfg, path)
    run = lambda name, conf, *extra: train.main(
        ["train", "--config", conf, "--algo", "DDPG", "--model_dir", str(tmp_path / name),
         "--device", "cpu", "--seed", "2", *extra])
    first = run("a", path)
    assert first["frames"] == 16 and first["done"] and first["updates"] == 8 * 2
    assert first["replay_rows"] == 8 + 16 and first["rows_off_priority_1"] is None
    assert all(np.isfinite(first["metrics"][k]) for k in ("critic_loss", "actor_loss"))
    quiet = str(tmp_path / "quiet.yaml")
    io_utils.save_yaml(dict(cfg, tpu=dict(cfg["tpu"], demo_frames=0)), quiet)
    again = run("c", quiet, "--load_dir", str(tmp_path / "a"))
    assert again["resume_frames"] == 16 and again["frames"] == 16
    assert again["ring_rows_restored"] == 16
    saved = cb.Checkpointer(str(tmp_path / "a")).restore()
    _equal(cb.Checkpointer(str(tmp_path / "c")).restore(), saved)
    assert set(saved["algo_state"]) == {"actor", "critic", "target_actor", "target_critic",
                                        "actor_opt", "critic_opt", "step"}
    snap_a = cb.RingCheckpointer(str(tmp_path / "a")).restore_raw()
    snap_c = cb.RingCheckpointer(str(tmp_path / "c")).restore_raw()
    for k in ("obs", "action", "reward"):
        assert torch.equal(snap_c[k], snap_a[k]), k
    assert snap_a["action"].dtype == torch.float32 and snap_a["action"].shape[1:] == (A,)
    # the export, evaluated by the port and read by the JAX loader
    out = str(tmp_path / "bundle")
    export_policy.main([str(tmp_path / "a"), "--out", out, "--latest", "--device", "cpu"])
    res = train.main(["run", "--npz", out, "--episodes", "2", "--device", "cpu"])
    assert res["episodes"] == 2 and np.isfinite(res["mean_return"])
    shape = (100,)
    template = jddpg.DeterministicActor(A, (16, 16)).init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + shape))["params"]
    back, _, _, meta = jpolicy_io.load_policy(out, template, jnorm.RunningMeanStd.init(shape),
                                              jnorm.RunningMeanStd.init(()))
    assert meta["algo"] == "DDPG"
    _, policy, _ = train.load_checkpoint_actor(str(tmp_path / "a"), "cpu")
    for k, v in _flax(policy.actor).items():
        np.testing.assert_array_equal(_leaves(_np(back))[k], v, err_msg=k)
