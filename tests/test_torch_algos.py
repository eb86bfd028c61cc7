"""The port's learner pieces vs the JAX package, on numpy-seeded inputs.

* Normalizer: `update_batch` over several env batches and
  `normalize_reward` match the JAX functions to float32 rounding (rtol
  1e-5: the same formulas, reductions in another order).
* Replay: `insert` over a ring that wraps, then the n-step gather on given
  indices, match the JAX buffer exactly (bf16 rows, float32 n-step sums in
  the same order); a whole `sample` matches JAX's when the port is handed
  the offsets JAX draws; the recency split is checked by its distribution.
* Twin critic: the torch `SACCritic` fed Flax `SACCritic` params through
  `policy_io` gives the Flax outputs at bf16 tolerance (5e-2 absolute +
  relative: both frameworks compute the trunk in bfloat16 but round at
  other places), for image (non-square, 5-channel) and flat observations.
* One `SAC.update`: from a Flax `SACState` carried across with
  `policy_io.load_sac_state` and one batch with a demonstration tail, with
  JAX's two normal draws reproduced from the same key and handed to the
  port. The networks run in float32 on both sides for this check (the
  algorithm is the point; CDTYPE is patched in both packages), so losses,
  alpha, entropy and the Bellman-target mean match to 1e-4 relative, and
  the updated parameters to 1e-6 on all but 0.5% of them and to 2 x the
  learning rate everywhere: Adam's first step is lr * g / (|g| + eps), so a
  gradient within rounding of zero can flip the sign of a step.
* TF32 is off (`train.set_precision()`); it would only matter on a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu.algos import normalize as jnorm
from deep_rl_grasping_tpu.algos import replay as jreplay
from deep_rl_grasping_tpu.algos import sac as jsac
from deep_rl_grasping_tpu.models import networks as jnet
from deep_rl_grasping_tpu_torch.algos import normalize as tnorm
from deep_rl_grasping_tpu_torch.algos import replay as treplay
from deep_rl_grasping_tpu_torch.algos import sac as tsac
from deep_rl_grasping_tpu_torch.models import networks as tnet
from deep_rl_grasping_tpu_torch.training.train import set_precision
from deep_rl_grasping_tpu_torch.utils import policy_io


@pytest.fixture(scope="module", autouse=True)
def _precision():
    set_precision()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))


# ---------------------------------------------------------------- normalizer

def test_normalizer_matches_jax():
    rng = np.random.default_rng(0)
    shape, B = (6, 5, 3), 8
    js = jnorm.NormalizerState.init(shape, B)
    ts = tnorm.NormalizerState.init(shape, B)
    for _ in range(5):
        obs = rng.normal(2.0, 3.0, (B,) + shape).astype(np.float32)
        rew = rng.normal(0.0, 50.0, B).astype(np.float32)
        done = rng.random(B) < 0.3
        js = jnorm.update_batch(js, jnp.asarray(obs), jnp.asarray(rew), jnp.asarray(done))
        ts = tnorm.update_batch(ts, torch.as_tensor(obs), torch.as_tensor(rew),
                                torch.as_tensor(done))
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(ts.obs_rms, f).numpy(),
                                   np.asarray(getattr(js.obs_rms, f)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(getattr(ts.ret_rms, f).numpy(),
                                   np.asarray(getattr(js.ret_rms, f)), rtol=1e-5)
    np.testing.assert_allclose(ts.returns.numpy(), np.asarray(js.returns), rtol=1e-6)
    r = rng.normal(0.0, 500.0, 64).astype(np.float32)
    np.testing.assert_allclose(tnorm.normalize_reward(ts, torch.as_tensor(r)).numpy(),
                               np.asarray(jnorm.normalize_reward(js, jnp.asarray(r))), rtol=1e-5)
    o = rng.normal(2.0, 3.0, (4,) + shape).astype(np.float32)
    np.testing.assert_allclose(tnorm.normalize_obs(ts, torch.as_tensor(o)).numpy(),
                               np.asarray(jnorm.normalize_obs(js, jnp.asarray(o))),
                               rtol=1e-5, atol=1e-5)
    assert tnorm.update_batch(ts, None, None, None, training=False) is ts


# ---------------------------------------------------------------- replay

OBS = (4, 3, 2)
STRIDE = 4


def _filled_buffers(n_batches=13, capacity=42):
    """Both buffers after inserting the same batches; the ring (capacity
    rounded to 40) wraps."""
    rng = np.random.default_rng(1)
    jb = jreplay.create(capacity, OBS, (5,), batch_stride=STRIDE)
    tb = treplay.create(capacity, OBS, (5,), batch_stride=STRIDE)
    for _ in range(n_batches):
        obs = rng.normal(size=(STRIDE,) + OBS).astype(np.float32)
        act = rng.uniform(-1, 1, (STRIDE, 5)).astype(np.float32)
        rew = rng.normal(size=STRIDE).astype(np.float32)
        done = rng.random(STRIDE) < 0.25
        jb = jreplay.insert(jb, jnp.asarray(obs), jnp.asarray(act), jnp.asarray(rew),
                            jnp.asarray(done))
        tb = treplay.insert(tb, torch.as_tensor(obs), torch.as_tensor(act), torch.as_tensor(rew),
                            torch.as_tensor(done))
    return jb, tb


def test_replay_insert_and_nstep_gather_match_jax():
    jb, tb = _filled_buffers()
    assert tb.capacity == jb.capacity == 40
    assert (tb.ptr, tb.size) == (int(jb.ptr), int(jb.size))
    np.testing.assert_array_equal(tb.obs.float().numpy(), np.asarray(jb.obs, np.float32))
    np.testing.assert_array_equal(tb.action.numpy(), np.asarray(jb.action))
    np.testing.assert_array_equal(tb.reward.numpy(), np.asarray(jb.reward))
    np.testing.assert_array_equal(tb.done.numpy(), np.asarray(jb.done))
    assert treplay._valid_range(tb, 3) == int(jreplay._valid_range(jb, 3))
    idx = np.arange(40, dtype=np.int32)
    for n_step in (1, 3):
        j = jreplay._nstep_gather(jb, jnp.asarray(idx), n_step, 0.99)
        t = treplay._nstep_gather(tb, torch.as_tensor(idx, dtype=torch.int64), n_step, 0.99)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_replay_sample_matches_jax_on_its_draws():
    jb, tb = _filled_buffers()
    key = jax.random.PRNGKey(2)
    jbatch = jreplay.sample(jb, key, 16, n_step=3, gamma=0.9)
    n = int(jreplay._valid_range(jb, 3))
    offs = np.asarray(jax.random.randint(key, (16,), 0, max(n, 1)))
    tbatch = treplay.gather(tb, torch.as_tensor(offs, dtype=torch.int64), n_step=3, gamma=0.9)
    for k, v in jbatch.items():
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(v), err_msg=k)


def test_replay_recency_split_distribution():
    rng = np.random.default_rng(3)
    tb = treplay.create(4096, (2,), (5,), batch_stride=64)
    for _ in range(64):
        treplay.insert(tb, torch.as_tensor(rng.normal(size=(64, 2)).astype(np.float32)),
                       torch.zeros(64, 5), torch.zeros(64), torch.zeros(64, dtype=torch.bool))
    n = treplay._valid_range(tb, 3)
    gen = torch.Generator().manual_seed(0)
    offs = torch.cat([treplay.draw_offsets(tb, gen, 256, 3, recent_batch=128, recent_window=512)
                      for _ in range(40)]).reshape(40, 256)
    old, rec = offs[:, :128].reshape(-1), offs[:, 128:].reshape(-1)
    assert int(rec.min()) >= n - 512 and int(rec.max()) < n
    assert int(old.min()) >= 0 and int(old.max()) < n
    # both halves are uniform over their ranges: mean and spread within 3%
    for x, lo, hi in ((old, 0, n), (rec, n - 512, n)):
        u = (x.double() - lo) / (hi - lo)
        assert abs(float(u.mean()) - 0.5) < 0.03 and abs(float(u.var()) - 1 / 12) < 0.03 / 12 * 4
    # without a recent slice every offset is uniform over the valid range
    flat = treplay.draw_offsets(tb, gen, 4096, 3)
    assert int(flat.max()) < n and abs(float(flat.double().mean()) / n - 0.5) < 0.03


# ---------------------------------------------------------------- critic

ATOL = RTOL = 5e-2


@pytest.mark.parametrize("obs_shape,layers", [((44, 52, 5), (32, 32)), ((10,), (16, 16))])
def test_critic_matches_flax(obs_shape, layers):
    image = len(obs_shape) == 3
    fc = jnet.SACCritic(layers, image)
    rng = np.random.default_rng(4)
    obs = rng.standard_normal((3,) + obs_shape).astype(np.float32)
    act = rng.uniform(-1, 1, (3, 5)).astype(np.float32)
    params = fc.init(jax.random.PRNGKey(0), jnp.asarray(obs), jnp.asarray(act))["params"]
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)
    q_f = np.asarray(fc.apply({"params": params}, jnp.asarray(obs), jnp.asarray(act)))
    tc = tnet.SACCritic(obs_shape, 5, layers, image)
    tc.load_state_dict(policy_io.critic_state_dict(_np(params), tc))
    with torch.no_grad():
        q_t = tc(torch.as_tensor(obs), torch.as_tensor(act)).numpy()
    assert q_t.shape == (3, 2)
    np.testing.assert_allclose(q_t, q_f, atol=ATOL, rtol=RTOL)
    assert np.abs(q_f).max() > 0.1


# ---------------------------------------------------------------- SAC update

def _sac_config():
    return {"discount_factor": 0.99,
            "SAC": {"layers": [16, 16], "batch_size": 16, "step_size": 3e-4,
                    "target_entropy": 0.0, "q_clip": [-0.5, 0.5], "bc_weight": 2.0},
            "tpu": {"demo_fraction": 0.25}}


@pytest.fixture
def float32_networks(monkeypatch):
    monkeypatch.setattr(jnet, "CDTYPE", jnp.float32)
    monkeypatch.setattr(tnet, "CDTYPE", torch.float32)


@pytest.fixture(scope="module")
def update_inputs():
    obs_shape, N, A = (36, 36, 5), 16, 5
    rng = np.random.default_rng(6)
    batch = dict(
        obs=rng.normal(size=(N,) + obs_shape).astype(np.float32),
        next_obs=rng.normal(size=(N,) + obs_shape).astype(np.float32),
        action=rng.uniform(-0.9, 0.9, (N, A)).astype(np.float32),
        reward=rng.normal(0.0, 0.3, N).astype(np.float32),
        done=rng.random(N) < 0.3,
        weight=np.r_[0.0, np.ones(N - 1)].astype(np.float32),
        is_demo=np.arange(N) >= N - 4,
    )
    batch["discount"] = (0.99 ** 3 * ~batch["done"]).astype(np.float32)
    return obs_shape, A, batch


def test_sac_update_matches_jax(float32_networks, update_inputs):
    obs_shape, A, batch = update_inputs
    cfg = _sac_config()
    jalgo = jsac.SAC(obs_shape, A, cfg)
    state = jalgo.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    # move the actor off its init so the policy has some spread, and give
    # the target critic its own values
    state = state.replace(
        actor_params=jax.tree.map(lambda p: p + 0.02 * rng.standard_normal(p.shape).astype(
            np.float32), state.actor_params),
        target_critic_params=jax.tree.map(lambda p: p + 0.02 * rng.standard_normal(
            p.shape).astype(np.float32), state.critic_params),
        log_alpha=jnp.asarray(-0.5, jnp.float32))
    key = jax.random.PRNGKey(9)
    new_state, jm, jtd = jax.jit(jalgo.update)(state, {k: jnp.asarray(v) for k, v in
                                                       batch.items()}, key)
    k1, k2 = jax.random.split(key)
    eps = [torch.as_tensor(np.asarray(jax.random.normal(k, (16, A)))) for k in (k1, k2)]

    talgo = tsac.SAC(obs_shape, A, cfg, device="cpu")
    policy_io.load_sac_state(talgo, _np(state.actor_params), _np(state.critic_params),
                             _np(state.target_critic_params), np.asarray(state.log_alpha))
    tm, ttd = talgo.update({k: torch.as_tensor(v) for k, v in batch.items()},
                           noise=tuple(eps))
    for k in ("critic_loss", "actor_loss", "bc_loss", "bc_gate", "alpha_loss", "alpha",
              "entropy", "td_abs", "q_target_mean", "reward_mean", "done_frac"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), rtol=1e-4, atol=1e-6)
    assert float(jm["bc_loss"]) > 0  # the demo tail took part
    assert talgo.step == 1

    lr = cfg["SAC"]["step_size"]
    pairs = [(talgo.actor.state_dict(),
              policy_io.actor_state_dict(_np(new_state.actor_params), talgo.actor)),
             (talgo.critic.state_dict(),
              policy_io.critic_state_dict(_np(new_state.critic_params), talgo.critic)),
             (talgo.target_critic.state_dict(),
              policy_io.critic_state_dict(_np(new_state.target_critic_params), talgo.critic))]
    diffs = np.concatenate([(t[k] - j[k]).abs().reshape(-1).numpy()
                            for t, j in pairs for k in j])
    assert diffs.max() <= 2 * lr + 1e-6
    assert (diffs > 1e-6).mean() <= 5e-3
    np.testing.assert_allclose(float(talgo.log_alpha), float(new_state.log_alpha), atol=1e-7)
    # the step moved the parameters
    moved = np.concatenate([(t[k] - policy_io.critic_state_dict(
        _np(state.critic_params), talgo.critic)[k]).abs().reshape(-1).numpy()
        for t in [talgo.critic.state_dict()] for k in t])
    assert (moved > 0.5 * lr).mean() > 0.5


def test_sac_update_runs_in_bf16_and_learning_rate_decays(update_inputs):
    """The production precision (bf16 trunks) gives finite losses, and the
    optional linear decay follows optax.linear_schedule."""
    import optax

    obs_shape, A, batch = update_inputs
    cfg = _sac_config()
    cfg["SAC"].update(lr_decay_steps=10, lr_decay_begin=2, lr_final_scale=0.1)
    talgo = tsac.SAC(obs_shape, A, cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    for _ in range(3):
        m, _ = talgo.update(tb, gen, target_entropy=-2.0)
        assert all(np.isfinite(float(v)) for v in m.values())
    sched = optax.linear_schedule(3e-4, 3e-5, 10, 2)
    for c in (0, 2, 5, 12, 40):
        assert talgo.lr_at(c) == pytest.approx(float(sched(c)), rel=1e-6)
    assert talgo.critic_opt.param_groups[0]["lr"] == pytest.approx(float(sched(2)), rel=1e-6)
