"""Port networks, bundle loader and normalizer vs the JAX package.

* The torch `SACActor` fed Flax `SACActor` params through
  `policy_io.load_actor_params` gives the Flax outputs on the same
  observations (a non-square image, so the NHWC->NCHW flatten fix before
  the 512-wide dense layer is exercised).
* The committed flagship bundle (trained/sac_full_flagship_r5c) loaded by
  the port's `policy_io.load_policy` gives the same actor outputs and the
  same normalizer moments as the JAX package's `policy_io.load_policy`.

Tolerance: both frameworks compute the convolutions and trunk layers in
bfloat16 (8-bit mantissa, ~0.4% per rounding) but round at different
places, so outputs are held to 5e-2 absolute + 5e-2 relative. Matmul
precision is stated and set: TF32 off (it would only matter on a GPU; these
tests run on the CPU, where float32 heads are exact float32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu.algos import normalize as jnorm
from deep_rl_grasping_tpu.models.networks import SACActor as FlaxActor
from deep_rl_grasping_tpu.utils import policy_io as jpolicy_io
from deep_rl_grasping_tpu_torch.algos import normalize as tnorm
from deep_rl_grasping_tpu_torch.algos import sac as tsac
from deep_rl_grasping_tpu_torch.models.networks import SACActor
from deep_rl_grasping_tpu_torch.training.train import set_precision
from deep_rl_grasping_tpu_torch.utils import policy_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(REPO, "trained", "sac_full_flagship_r5c")
ATOL = RTOL = 5e-2


@pytest.fixture(scope="module", autouse=True)
def _precision():
    set_precision()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))


@pytest.mark.parametrize("obs_shape,layers", [((44, 52, 2), (32, 32)), ((36, 36, 2), (16,))])
def test_actor_matches_flax(obs_shape, layers):
    flax_actor = FlaxActor(5, layers, True)
    params = flax_actor.init(jax.random.PRNGKey(0), jnp.zeros((1,) + obs_shape))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    obs = rng.standard_normal((3,) + obs_shape).astype(np.float32)
    mean_f, log_std_f = flax_actor.apply({"params": params}, jnp.asarray(obs))
    actor = policy_io.load_actor_params(SACActor(obs_shape, 5, layers, image_obs=True),
                                        _np_tree(params))
    with torch.no_grad():
        mean_t, log_std_t = actor(torch.as_tensor(obs))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_f), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(log_std_t.numpy(), np.asarray(log_std_f), atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def bundles():
    flax_actor = FlaxActor(5, (256, 256), True)
    template = flax_actor.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 2)))["params"]
    jparams, jobs, jret, jmeta = jpolicy_io.load_policy(
        BUNDLE, template, jnorm.RunningMeanStd.init((64, 64, 2)), jnorm.RunningMeanStd.init(()))
    actor, norm, meta = policy_io.load_policy(BUNDLE, SACActor((64, 64, 2), 5, (256, 256), True))
    return flax_actor, jparams, jobs, jret, jmeta, actor, norm, meta


def test_bundle_moments_match_jax(bundles):
    _, _, jobs, jret, jmeta, _, norm, meta = bundles
    assert meta == jmeta
    for name in ("mean", "var", "count"):
        np.testing.assert_array_equal(getattr(norm.obs_rms, name).numpy(),
                                      np.asarray(getattr(jobs, name)))
        np.testing.assert_array_equal(getattr(norm.ret_rms, name).numpy(),
                                      np.asarray(getattr(jret, name)))


def test_bundle_actor_matches_flax(bundles):
    """The flagship's actor on normalized depth observations, as evaluation
    feeds it."""
    flax_actor, jparams, jobs, jret, _, actor, norm, _ = bundles
    rng = np.random.default_rng(1)
    obs = np.zeros((4, 64, 64, 2), np.float32)
    obs[..., 0] = rng.uniform(0.05, 0.45, (4, 64, 64))
    obs[:, 0, 0, 1] = rng.uniform(0.0, 1.0, 4)
    jn = jnorm.NormalizerState(obs_rms=jobs, ret_rms=jret, returns=jnp.zeros(4))
    obs_j = jnorm.normalize_obs(jn, jnp.asarray(obs))
    obs_t = tnorm.normalize_obs(norm, torch.as_tensor(obs))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=1e-5, rtol=1e-6)
    mean_f, log_std_f = flax_actor.apply({"params": jparams}, obs_j)
    with torch.no_grad():
        mean_t, log_std_t = actor(obs_t)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_f), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(log_std_t.numpy(), np.asarray(log_std_f), atol=ATOL, rtol=RTOL)
    # the deterministic action is tanh(mean), as SAC.act (sac.py:156)
    np.testing.assert_allclose(tsac.act(actor, obs_t, deterministic=True).numpy(),
                               np.tanh(mean_t.numpy()), rtol=0, atol=1e-6)


def test_stochastic_act_uses_the_generator(bundles):
    *_, actor, norm, _ = bundles
    obs = tnorm.normalize_obs(norm, torch.full((2, 64, 64, 2), 0.3))
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a1 = tsac.act(actor, obs, g1)
    a2 = tsac.act(actor, obs, g2)
    assert torch.equal(a1, a2) and a1.shape == (2, 5)
    assert bool((a1.abs() <= 1).all())
    assert not torch.equal(a1, tsac.act(actor, obs, deterministic=True))


def test_bundle_with_wrong_shape_is_refused():
    with pytest.raises(ValueError):
        policy_io.load_policy(BUNDLE, SACActor((64, 64, 2), 5, (128, 128), True))
