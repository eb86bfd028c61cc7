"""Encoder-latent observations in the port vs the JAX package.

(a) `ConvEncoder` with the `encoder_files/full_r4` weights against the JAX
    package's `load_trained_encoder` on the same masked depth images (B=8),
    at 64 x 64 and at 61 x 62, where the SAME pads differ per axis. Both
    compute in bfloat16 and round at other places: 2e-2 absolute, about
    2.5 bf16 ulps at the latents' scale (~1.5; the gap seen is one ulp,
    0.0078).
(b) `encoder_state_dict` uses every `encoder/*` array, loads strictly, and
    refuses a layer it does not know.
(c) The latent observation of the port's env against the JAX env's
    `assemble_obs` from the same JAX-built states, on an OnTable (tray)
    config, an OnFloor one and one with the time feature. The JAX side
    renders through its Pallas raster in interpret mode (its XLA renderer
    keeps the gripper-rotation fault, ROADMAP Queue 3). On the JAX render's
    own depth and seg the port's masked image equals the JAX one exactly
    (the JAX env's encoder is swapped for a flatten to read it) and its
    latent is within 2e-2. Through the port's own render (the raster's
    plain version, which may flip an id at an edge pixel, see
    tests/test_torch_env.py) the latent is within 3e-2 of JAX's, the
    actuator observation within 1e-5 and the time feature within 1e-6.
(d) The `trained/sac_encoder_flagship_r5` bundle's actor (MLP torso on 101
    latents) against the Flax actor on the same normalized latents, at the
    bf16 tolerance of tests/test_torch_networks.py (5e-2); its moments are
    the JAX loader's exactly.
(e) The refusals: encoder mode without `sensor.encoder_dir` or with no
    `weights.npz` in it (the JAX package would run a stand-in), and on the
    simplified task (which now evaluates on 100-wide latents) the RGB-D
    observation.

Also the env contract for this mode (tests/test_env_contract.py): the
observation space is (101,) and the full task's first zero-action step
pays exactly -11; and one `Trainer` iteration on the encoder flagship's
config cut to 2 envs stores 101-wide bf16 replay rows and runs an update.
The JAX envs are built at B=8 in module-scoped fixtures.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu.algos import normalize as jnorm
from deep_rl_grasping_tpu.envs import grasp_env as jenv
from deep_rl_grasping_tpu.models import autoencoder as jae
from deep_rl_grasping_tpu.models.networks import SACActor as FlaxActor
from deep_rl_grasping_tpu.ops.raster_pallas import render_batch_pallas
from deep_rl_grasping_tpu.render import raycast as jraycast
from deep_rl_grasping_tpu.training import train_encoder as jte
from deep_rl_grasping_tpu.utils import config as jcfg
from deep_rl_grasping_tpu.utils import policy_io as jpolicy_io
from deep_rl_grasping_tpu_torch.algos import normalize as tnorm
from deep_rl_grasping_tpu_torch.envs import grasp_env as tenv
from deep_rl_grasping_tpu_torch.models.autoencoder import ConvEncoder
from deep_rl_grasping_tpu_torch.training import train as ttrain
from deep_rl_grasping_tpu_torch.training import train_encoder as tte
from deep_rl_grasping_tpu_torch.training.trainer import Evaluator, Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODER_DIR = os.path.join(REPO, "encoder_files", "full_r4")
BUNDLE = os.path.join(REPO, "trained", "sac_encoder_flagship_r5")
TEST_CONFIG = os.path.join(REPO, "tests", "configs", "test_encoder.yaml")
ENC_TOL = 2e-2
B = 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def encoders():
    """(JAX per-image encode, Flax params as numpy, the port's encoder)."""
    enc_fn, params = jte.load_trained_encoder(ENCODER_DIR)
    return enc_fn, jax.tree.map(np.asarray, params), tte.load_trained_encoder(ENCODER_DIR)


def masked_depth(rng, n, h, w):
    """Depth images as the env masks them: object blobs at 0.25-0.45 m on
    zeros."""
    yy, xx = np.mgrid[:h, :w]
    img = np.zeros((n, h, w, 1), np.float32)
    for i in range(n):
        for _ in range(3):
            cy, cx, r = rng.uniform(10, h - 10), rng.uniform(10, w - 10), rng.uniform(4, 12)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
            img[i, blob, 0] = rng.uniform(0.25, 0.45) + 0.01 * rng.standard_normal(blob.sum())
    return img


# ------------------------------------------------------------------ (a), (b)

@pytest.mark.parametrize("hw", [(64, 64), (61, 62)], ids=["64x64", "61x62"])
def test_encoder_matches_jax(encoders, hw):
    _, params, port = encoders
    img = masked_depth(np.random.default_rng(0), B, *hw)
    model = jae.SimpleAutoEncoder()
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(img), method=model.encode))
    if hw != (64, 64):
        port = ConvEncoder(in_hw=hw)
        port.load_state_dict(tte.encoder_state_dict(params), strict=True)
    with torch.no_grad():
        got = port(torch.as_tensor(img)).numpy()
    assert got.shape == ref.shape == (B, 100) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ENC_TOL, rtol=0)
    assert np.abs(ref).max() > 0.5 and np.abs(ref[0] - ref[1]).max() > 0.05


def test_pads_follow_xla_same():
    from deep_rl_grasping_tpu_torch.models.autoencoder import same_pads

    assert [same_pads(n, k, 2) for n, k in ((64, 7), (32, 5), (16, 3))] == [(2, 3), (1, 2), (0, 1)]
    assert [same_pads(n, k, 2) for n, k in ((61, 7), (31, 5), (16, 3))] == [(3, 3), (2, 2), (0, 1)]


def test_encoder_state_dict_uses_every_encoder_array(encoders):
    _, params, port = encoders
    sd = tte.encoder_state_dict(params)
    n_arrays = sum(len(layer) for layer in params["encoder"].values())
    assert len(sd) == n_arrays == 8 and set(sd) == set(port.state_dict())
    np.testing.assert_array_equal(sd["convs.0.weight"].numpy(),
                                  params["encoder"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["dense.weight"].numpy(),
                                  params["encoder"]["Dense_0"]["kernel"].T)
    for k, v in port.state_dict().items():
        assert torch.equal(v, sd[k]), k
    extra = copy.deepcopy(params)
    extra["encoder"]["Conv_9"] = extra["encoder"]["Conv_2"]
    with pytest.raises(RuntimeError):  # strict load: a conv the module does not have
        ConvEncoder().load_state_dict(tte.encoder_state_dict(extra), strict=True)
    extra["encoder"]["LayerNorm_0"] = {"scale": np.ones(3, np.float32)}
    with pytest.raises(ValueError, match="LayerNorm_0"):
        tte.encoder_state_dict(extra)
    missing = copy.deepcopy(params)
    del missing["encoder"]["Dense_0"]
    with pytest.raises(RuntimeError):
        ConvEncoder().load_state_dict(tte.encoder_state_dict(missing), strict=True)


# ------------------------------------------------------------------ (c)

def encoder_config(scene_type="OnTable", time_feature=False):
    """tests/configs/test_encoder.yaml with the trained encoder, cut to 3
    object slots."""
    cfg = jcfg.load_config(TEST_CONFIG)
    cfg["sensor"]["encoder_dir"] = "encoder_files/full_r4"
    cfg["scene"]["scene_type"] = scene_type
    cfg["time_feature"] = time_feature
    cfg["tpu"].update(max_objects=3, gripper_substeps=4, solver_iterations=2,
                      pad_inner_iterations=2)
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


CASES = {"ontable_tray": ("OnTable", False), "onfloor": ("OnFloor", False),
         "ontable_time_feature": ("OnTable", True)}


@pytest.fixture(scope="module", params=list(CASES))
def latent_case(request, encoders):
    """B JAX-built reset states (lambda 1, grippers lowered over the
    objects so that they fill the view), the JAX render through the Pallas
    kernel, the JAX observation and masked image, and the port's env."""
    enc_fn, _, port_enc = encoders
    scene_type, time_feature = CASES[request.param]
    cfg = encoder_config(scene_type, time_feature)
    je = jenv.GraspEnv(cfg, evaluate=True, validate=True, encoder_fn=enc_fn)
    je_img = jenv.GraspEnv(cfg, evaluate=True, validate=True,
                           encoder_fn=lambda img: img.reshape(-1))
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    js = jax.jit(jax.vmap(lambda k: je.reset_env(k, 1.0, settle_substeps=0)))(keys)
    rng = np.random.default_rng(8)
    q = np.array(js.sim.gripper.q)
    q[:, 2] = rng.uniform(0.05, 0.2, B)
    q[:, 3] = rng.uniform(-3.1, 3.1, B)
    js = js.replace(sim=js.sim.replace(gripper=js.sim.gripper.replace(q=jnp.asarray(q))),
                    episode_step=jnp.asarray(rng.integers(0, je.time_horizon, B), jnp.int32))
    cam_pos, cam_R = jax.vmap(jraycast.camera_pose_from_gripper)(
        js.sim.gripper.q, js.cam_t, js.cam_R)
    depth, seg = render_batch_pallas(js.sim, je.sim_params, cam_pos, cam_R, js.intrinsics,
                                     H=je.im_h, W=je.im_w, near=je.near, far=je.far,
                                     interpret=True)
    assemble = lambda env: np.asarray(jax.vmap(
        lambda st, d, m: env.assemble_obs(st, None, d, m))(js, depth, seg))
    te = tenv.GraspEnv(cfg, evaluate=True, validate=True, device="cpu", encoder=port_enc)
    return dict(cfg=cfg, je=je, te=te, states=tenv.env_state_from_numpy(_flat(js)),
                depth=np.asarray(depth), seg=np.asarray(seg), jobs=assemble(je),
                jimg=assemble(je_img)[:, :je.im_h * je.im_w].reshape(B, je.im_h, je.im_w))


def test_masked_image_matches_jax_exactly(latent_case):
    c = latent_case
    te, seg = c["te"], c["seg"]
    got = te.encoder_input(torch.as_tensor(c["depth"]), torch.as_tensor(seg)).numpy()
    np.testing.assert_array_equal(got, c["jimg"])
    # the render holds what the mask must drop: the gripper (and on OnTable
    # the table or the tray) beside objects that stay
    gripper_id = te.max_slots + (3 if te.sim_params.has_tray else 1)
    assert (seg == gripper_id).sum() > 0 and ((seg > 0) & (seg < gripper_id)).sum() > 0
    assert (got[seg == gripper_id] == 0).all() and (got > 0).sum() > 100
    if te.scene_type == "OnTable":
        assert np.isin(seg, [1, 2]).sum() > 0 and (got[np.isin(seg, [1, 2])] == 0).all()


def test_latent_observation_matches_jax(latent_case):
    c = latent_case
    te, jobs = c["te"], c["jobs"]
    d = 102 if c["cfg"]["time_feature"] else 101
    assert te.obs_shape == c["je"].obs_shape == jobs.shape[1:] == (d,)
    # the port's assembly on the JAX render
    with torch.no_grad():
        obs = te.assemble_obs(c["states"], torch.as_tensor(c["depth"]),
                              seg=torch.as_tensor(c["seg"])).numpy()
    np.testing.assert_allclose(obs[:, :100], jobs[:, :100], atol=ENC_TOL, rtol=0)
    np.testing.assert_allclose(obs[:, 100:], jobs[:, 100:], atol=1e-6, rtol=0)
    # the port's own observation path (plain render on CPU tensors)
    benv = tenv.BatchedGraspEnv(te, B, torch.Generator().manual_seed(0))
    with torch.no_grad():
        own = benv.observe_batch(c["states"]).numpy()
    assert own.shape == (B, d) and np.isfinite(own).all()
    np.testing.assert_allclose(own[:, :100], jobs[:, :100], atol=3e-2, rtol=0)
    np.testing.assert_allclose(own[:, 100], jobs[:, 100], atol=1e-5, rtol=0)
    if c["cfg"]["time_feature"]:
        np.testing.assert_allclose(own[:, 101], jobs[:, 101], atol=1e-6, rtol=0)
        steps = c["states"].episode_step.numpy()
        np.testing.assert_allclose(own[:, 101], 1.0 - steps / te.time_horizon, atol=1e-6)
    assert np.abs(jobs[:, :100]).max() > 0.5


# ------------------------------------------------------------------ (d)

def test_bundle_actor_matches_jax():
    config, actor, norm = ttrain.load_bundle_actor(BUNDLE, "cpu")
    assert actor.obs_shape == (101,) and not actor.image_obs
    flax_actor = FlaxActor(5, (256, 256), False)
    template = flax_actor.init(jax.random.PRNGKey(0), jnp.zeros((1, 101)))["params"]
    jparams, jobs_rms, jret, _ = jpolicy_io.load_policy(
        BUNDLE, template, jnorm.RunningMeanStd.init((101,)), jnorm.RunningMeanStd.init(()))
    for name in ("mean", "var", "count"):
        np.testing.assert_array_equal(getattr(norm.obs_rms, name).numpy(),
                                      np.asarray(getattr(jobs_rms, name)))
    rng = np.random.default_rng(2)
    mean, std = np.asarray(jobs_rms.mean), np.sqrt(np.asarray(jobs_rms.var))
    obs = (mean + std * rng.standard_normal((6, 101))).astype(np.float32)
    jn = jnorm.NormalizerState(obs_rms=jobs_rms, ret_rms=jret, returns=jnp.zeros(6))
    obs_j = jnorm.normalize_obs(jn, jnp.asarray(obs))
    obs_t = tnorm.normalize_obs(norm, torch.as_tensor(obs))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), atol=1e-5, rtol=1e-6)
    mean_f, log_std_f = flax_actor.apply({"params": jparams}, obs_j)
    with torch.no_grad():
        mean_t, log_std_t = actor(obs_t)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_f), atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(log_std_t.numpy(), np.asarray(log_std_f), atol=5e-2, rtol=5e-2)
    assert np.abs(np.asarray(mean_f)).max() > 0.1


# ------------------------------------------------------------------ (e)

def test_refuses_a_missing_encoder(tmp_path):
    cfg = encoder_config()
    cfg["sensor"]["encoder_dir"] = None
    with pytest.raises(ValueError, match="sensor.encoder_dir"):
        Evaluator(cfg, device="cpu")
    empty = tmp_path / "no_weights"
    empty.mkdir()
    cfg["sensor"]["encoder_dir"] = str(empty)
    for build in (lambda: Evaluator(cfg, device="cpu"), lambda: Trainer(cfg, device="cpu")):
        with pytest.raises(ValueError, match=str(empty)):
            build()
    with pytest.raises(ValueError, match="encoder"):
        tenv.GraspEnv(encoder_config(), device="cpu")  # latent mode with no encoder passed


def test_refuses_the_simplified_task():
    """The simplified task is ported: it evaluates on 100-wide latents (no
    actuator entry, grasp_env.py:191-194). The one simplified setting the
    port refuses is the RGB-D observation, which the JAX package cannot run
    either (its observation has 2 channels where its obs_shape says 5)."""
    from deep_rl_grasping_tpu_torch.algos.normalize import NormalizerState
    from deep_rl_grasping_tpu_torch.models.networks import SACActor

    cfg = encoder_config()
    cfg["simplified"] = True
    cfg["time_horizon"] = 1
    cfg["tpu"]["move_substeps"] = 2
    torch.manual_seed(0)
    res = Evaluator(cfg, device="cpu").evaluate(SACActor((100,), 3, (16, 16)),
                                                NormalizerState.init((100,), 1), n_episodes=1)
    assert res["episodes"] == 1 and res["control_steps"] == 1
    cfg.update(depth_observation=True, full_observation=True)
    with pytest.raises(ValueError, match="simplified"):
        Evaluator(cfg, device="cpu").evaluate(None, None, n_episodes=1)


# ------------------------------------------------------------------ contract

def test_env_contract_observation_space_and_first_reward(encoders):
    """tests/test_env_contract.py's `encoder` case for the port: obs (101,),
    and -(grasp_reward + delta_z_scale * max_translation) = -11 for a zero
    action on the first step."""
    cfg = encoder_config()
    cfg["tpu"]["gripper_substeps"] = 2
    env = tenv.GraspEnv(cfg, device="cpu", encoder=encoders[2])
    benv = tenv.BatchedGraspEnv(env, 2, torch.Generator().manual_seed(0))
    cur = benv.init_curriculum()
    with torch.no_grad():
        states, obs = benv.reset(cur)
        _, obs2, reward, done, _, _ = benv.step(states, torch.zeros(2, 5), cur)
    assert env.obs_shape == (101,) and obs.shape == obs2.shape == (2, 101)
    assert np.isfinite(obs.numpy()).all()
    assert reward.tolist() == [-11.0, -11.0] and not done.any()


def test_trainer_iteration_on_latents():
    cfg = jcfg.load_config(os.path.join(REPO, "configs", "sac_encoder_flagship.yaml"))
    cfg["tpu"].update(num_envs=2, max_objects=3, gripper_substeps=2, solver_iterations=1,
                      pad_inner_iterations=1, updates_per_step=1, demo_frames=0,
                      demo_fraction=0.0, recent_window=8)
    cfg["SAC"].update(batch_size=4, buffer_size=16, learning_starts=4, layers=[16, 16])
    trainer = Trainer(cfg, device="cpu", seed=1)
    assert trainer.env.obs_shape == trainer.algo.obs_shape == (101,)
    state = trainer.init_state()
    assert state.buffer.obs.shape == (16, 101) and state.buffer.obs.dtype == torch.bfloat16
    assert state.normalizer.obs_rms.mean.shape == (101,)
    for _ in range(4):
        prev = state.obs
        state, metrics = trainer.train_step(state)
    assert state.buffer.size == 8 and trainer.algo.step >= 1
    assert all(np.isfinite(float(metrics[k])) for k in ("critic_loss", "actor_loss"))
    # the last iteration stored the observation it acted on, in bf16
    np.testing.assert_array_equal(state.buffer.obs[6:8].float().numpy(),
                                  prev.to(torch.bfloat16).float().numpy())
    assert float(prev.abs().max()) > 0.1
