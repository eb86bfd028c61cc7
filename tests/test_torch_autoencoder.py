"""The depth-image autoencoder, its training CLI and the dataset collector
in the port vs the JAX package, on the CPU at a small size.

(a) Nearest upsampling by an integer factor: `F.interpolate(mode=
    "nearest")` picks the same source pixels (i // s) as
    `jax.image.resize(method="nearest")`, exactly.
(b) `SimpleAutoEncoder` forward from the same Flax params (32-32-32
    filters, 100 latents, 64 x 64 images): latents and reconstructions at
    bf16 tolerance (2e-2 absolute; both compute in bfloat16 and round at
    other places).
(c) Training steps (`ae_train_step`, MSE, the port's Adam of
    `create_ae_train_state` against `optax.adam`) from the same params
    and batches. One step: the kernels' gradients to 5% in L2 (bf16; the
    bias gradients, sums over 65536 pixels of residuals that nearly
    cancel, are off by up to 80% against float32 in both frameworks, and
    are held only through the step), the loss to 1e-2 relative, and every
    parameter after the step within 2 x the learning rate of JAX's (Adam's
    first step is lr * g / (|g| + eps), so a bf16 gradient within rounding
    of zero may flip a step), all but 5% within 0.1 x the learning rate
    (seen: 2.6%). Three steps: each loss to 1e-3 relative, all but 5% of
    the parameters within 0.5 x the learning rate. The optimizer alone on
    the same float32 gradients: optax's parameters to 1e-3 x the learning
    rate (a few float32 ulps). TF32 is off (`train.set_precision()`); it would only matter on a
    GPU.
(d) The port's Flax-style initialization: zero biases, LeCun-normal
    kernels truncated at two standard deviations.
(e) `weights.npz` written by the port (tiny filters) in the JAX layout:
    the JAX package's `load_trained_encoder` reads it unedited into the
    tree `SimpleAutoEncoder.init` builds, and gives the port's latents; the
    port's own loaders read it back exactly.
(f) `train_encoder train / test` on a tiny dataset: history.csv, the best
    weights, early stopping after PATIENCE epochs without a gain, and the
    test MSE of the saved weights.
(g) `masked_depth` of the collector against the JAX collector's on the
    same JAX-built OnTable tray states: at zero gripper yaw against the
    JAX `collect_dataset.masked_depth` (its XLA renderer); at yaws over the
    circle against the Pallas raster in interpret mode with the same mask
    rule, since the XLA renderer rotates the gripper boxes otherwise
    (ROADMAP Queue 3). Depth to 1e-4 on all but 0.1% of the pixels (an
    id may flip at an edge pixel under float32 rounding).
(h) `collect_dataset` on the CPU: the images and the npz the CLI writes.
(i) `encoder_files/full_torch_r1`, trained by the port on the card, read by
    the JAX package's loader.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_rl_grasping_tpu.envs import grasp_env as jenv
from deep_rl_grasping_tpu.models import autoencoder as jae
from deep_rl_grasping_tpu.ops.raster_pallas import render_batch_pallas
from deep_rl_grasping_tpu.render import raycast as jraycast
from deep_rl_grasping_tpu.training import collect_dataset as jcollect
from deep_rl_grasping_tpu.training import train_encoder as jte
from deep_rl_grasping_tpu.utils import config as jcfg
from deep_rl_grasping_tpu_torch.envs import grasp_env as tenv
from deep_rl_grasping_tpu_torch.models import autoencoder as tae
from deep_rl_grasping_tpu_torch.training import collect_dataset as tcollect
from deep_rl_grasping_tpu_torch.training import train_encoder as tte
from deep_rl_grasping_tpu_torch.training.train import set_precision
from deep_rl_grasping_tpu_torch.utils import io_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-2
LR = 2e-4
TINY = {"network": [{"filters": 4, "kernel_size": 7, "strides": 2},
                    {"filters": 4, "kernel_size": 5, "strides": 2},
                    {"filters": 4, "kernel_size": 3, "strides": 2}],
        "encoding_dim": 10, "learning_rate": LR, "batch_size": 8, "epochs": 3}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    set_precision()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def images(n, seed=0, hw=64):
    """Depth images as the collector masks them: object blobs at
    0.25-0.45 m on zeros."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw]
    img = np.zeros((n, hw, hw, 1), np.float32)
    for i in range(n):
        for _ in range(3):
            cy, cx, r = rng.uniform(10, hw - 10, 2).tolist() + [rng.uniform(4, 12)]
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
            img[i, blob, 0] = rng.uniform(0.25, 0.45) + 0.01 * rng.standard_normal(blob.sum())
    return img


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def flax_ae():
    model = jae.SimpleAutoEncoder()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))["params"]
    port = tae.SimpleAutoEncoder()
    port.load_state_dict(tte.ae_state_dict(_np(params)), strict=True)
    return model, params, port


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("s", [2, 3])
def test_nearest_upsampling_matches_jax(s):
    x = np.random.default_rng(s).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 5 * s, 7 * s, 3), method="nearest"))
    got = F.interpolate(torch.as_tensor(x).permute(0, 3, 1, 2), scale_factor=s,
                        mode="nearest").permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, x[:, np.arange(5 * s) // s][:, :, np.arange(7 * s) // s])


# ------------------------------------------------------------------ (b)

def test_autoencoder_forward_matches_jax(flax_ae):
    model, params, port = flax_ae
    x = images(8)
    z_ref = np.asarray(model.apply({"params": params}, jnp.asarray(x), method=model.encode))
    y_ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        z = port.encode(torch.as_tensor(x))
        y = port(torch.as_tensor(x)).numpy()
        y_dec = port.decoder(torch.as_tensor(z_ref)).numpy()
    assert y.shape == y_ref.shape == (8, 64, 64, 1) and y.dtype == np.float32
    np.testing.assert_allclose(z.numpy(), z_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(y, y_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(y_dec, y_ref, atol=TOL, rtol=0)
    assert np.abs(y_ref).max() > 0.05 and np.abs(y_ref[0] - y_ref[1]).max() > 0.01


# ------------------------------------------------------------------ (c)

def _port_like(params):
    """The port's autoencoder and optimizer (`create_ae_train_state`) with
    the Flax `params` loaded."""
    port = tae.SimpleAutoEncoder()
    opt = tae.create_ae_train_state(port, torch.Generator().manual_seed(0), LR)
    port.load_state_dict(tte.ae_state_dict(_np(params)), strict=True)
    return port, opt


def _gaps(port, params):
    ref = tte.ae_state_dict(_np(params))
    return {k: (port.state_dict()[k] - ref[k]).abs().reshape(-1).numpy() for k in ref}


def test_one_train_step_matches_jax(flax_ae):
    model, _, _ = flax_ae
    state, tx = jae.create_ae_train_state(model, jax.random.PRNGKey(1), LR)
    x = images(16, seed=1)
    loss_fn = lambda p, b: jnp.mean((model.apply({"params": p}, b) - b) ** 2)
    grads_ref = tte.ae_state_dict(_np(jax.grad(loss_fn)(state.params, jnp.asarray(x))))
    new_state, loss_ref = jax.jit(lambda s, b: jae.ae_train_step(model, tx, s, b))(
        state, jnp.asarray(x))
    port, opt = _port_like(state.params)
    xt = torch.as_tensor(x)
    torch.mean((port(xt) - xt) ** 2).backward()
    for k, p in port.named_parameters():
        if k.endswith("weight"):  # the kernels' gradients, seen within 3.4%
            g, r = p.grad.numpy(), grads_ref[k].numpy()
            assert np.linalg.norm(g - r) <= 0.05 * np.linalg.norm(r), k
    loss = tae.ae_train_step(port, opt, xt)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-2)
    gap = _gaps(port, new_state.params)
    kernels = np.concatenate([v for k, v in gap.items() if k.endswith("weight")])
    biases = np.concatenate([v for k, v in gap.items() if k.endswith("bias")])
    old_sd = tte.ae_state_dict(_np(state.params))
    moved = np.concatenate([(tte.ae_state_dict(_np(new_state.params))[k] - old_sd[k]).abs()
                            .reshape(-1).numpy() for k in old_sd])
    assert max(kernels.max(), biases.max()) <= 2 * LR * (1 + 1e-3) + 1e-7
    # steps that part: those on gradients within bf16 rounding of zero (seen:
    # 2.6% of the kernels' entries, 1.9% of the biases')
    assert (kernels > 0.1 * LR).mean() <= 0.05 and (biases > 0.1 * LR).mean() <= 0.05
    assert (moved > 0.5 * LR).mean() > 0.5  # the step moved the parameters


def test_three_train_steps_match_jax(flax_ae):
    """Three steps on three batches from the same params: the loss before
    each step (seen within 8e-5 relative), and the parameters after the
    last (seen: 2.1% of the entries more than 0.5 x LR apart)."""
    model, _, _ = flax_ae
    state, tx = jae.create_ae_train_state(model, jax.random.PRNGKey(1), LR)
    port, opt = _port_like(state.params)
    step = jax.jit(lambda s, b: jae.ae_train_step(model, tx, s, b))
    losses = []
    for seed in (1, 2, 3):
        x = images(16, seed=seed)
        state, loss_ref = step(state, jnp.asarray(x))
        losses.append((float(tae.ae_train_step(port, opt, torch.as_tensor(x))), float(loss_ref)))
    for got, ref in losses:
        assert got == pytest.approx(ref, rel=1e-3)
    assert losses[2][1] < losses[0][1]  # the steps lowered the loss
    gap = np.concatenate(list(_gaps(port, state.params).values()))
    assert (gap > 0.5 * LR).mean() <= 0.05


def test_adam_matches_optax():
    """The port's optimizer against `optax.adam(LR)` on float32 parameters
    over three steps of the same gradients, some of them of the size of
    eps (1e-8), where eps inside the square root or a missing bias
    correction would show."""
    import optax

    rng = np.random.default_rng(4)
    port = tae.SimpleAutoEncoder.from_config(TINY)
    opt = tae.create_ae_train_state(port, torch.Generator().manual_seed(0), LR)
    params = {k: v.detach().numpy().copy() for k, v in port.named_parameters()}
    tx = optax.adam(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    for i in range(3):
        grads = {k: (rng.standard_normal(v.shape) * (1e-8 if j % 3 == 0 else 10.0 ** -i))
                 .astype(np.float32) for j, (k, v) in enumerate(params.items())}
        for k, p in port.named_parameters():
            p.grad = torch.as_tensor(grads[k])
        opt.step()
        updates, opt_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, opt_state,
                                       jp)
        jp = optax.apply_updates(jp, updates)
    for k, p in port.named_parameters():
        moved = np.abs(np.asarray(jp[k]) - params[k]).max()
        assert moved > 0.5 * LR, k
        # float32 rounding of parameters near 0.2 is ~1e-4 x LR per ulp
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-3 * LR, err_msg=k)


# ------------------------------------------------------------------ (d)

def test_init_follows_flax():
    model = tae.create_ae_train_state(tae.SimpleAutoEncoder(), torch.Generator().manual_seed(0))
    port = model.param_groups[0]["params"]
    assert len(port) == 16
    for p in port:
        if p.dim() == 1:
            assert float(p.abs().max()) == 0.0
            continue
        std = (1.0 / p[0].numel()) ** 0.5
        assert float(p.std()) == pytest.approx(std, rel=0.15)
        assert float(p.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    again = tae.SimpleAutoEncoder()
    tae.init_params_(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(port, again.parameters()))


# ------------------------------------------------------------------ (e)

def test_weights_round_trip_through_the_jax_loader(tmp_path):
    port = tae.SimpleAutoEncoder.from_config(TINY)
    tae.init_params_(port, torch.Generator().manual_seed(3))
    with torch.no_grad():  # nonzero biases, so that a mixed-up bias shows
        for p in port.parameters():
            if p.dim() == 1:
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(p.numel()))
    io_utils.save_yaml(TINY, str(tmp_path / "config.yaml"))
    tte.save_weights(port, str(tmp_path / "weights.npz"))
    encode_fn, params = jte.load_trained_encoder(str(tmp_path))
    flax_model = jte.build_model(TINY)
    ref_tree = flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))["params"]
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), jax.tree.map(np.asarray, t))
    assert shapes(params) == shapes(dict(ref_tree))
    x = images(4, seed=2)
    z_ref = np.stack([np.asarray(encode_fn(jnp.asarray(img))) for img in x])
    y_ref = np.asarray(flax_model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        z = tte.load_trained_encoder(str(tmp_path))(torch.as_tensor(x)).numpy()
        y = tte.load_trained_autoencoder(str(tmp_path))(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(z, z_ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(y, y_ref, atol=TOL, rtol=0)
    assert np.abs(z_ref).max() > 0.05
    back = tte.load_trained_autoencoder(str(tmp_path)).state_dict()
    assert all(torch.equal(v, back[k]) for k, v in port.state_dict().items())


# ------------------------------------------------------------------ (f)

def _dataset(path, n_train=48, n_test=8):
    x = images(n_train + n_test, seed=5)
    np.savez_compressed(path, train=x[:n_train], test=x[n_train:])
    return x


def test_train_and_test_cli(tmp_path, monkeypatch):
    data = str(tmp_path / "data.npz")
    x = _dataset(data)
    cfg_path = str(tmp_path / "enc.yaml")
    io_utils.save_yaml(TINY, cfg_path)
    out = str(tmp_path / "enc")
    res = tte.main(["train", "--config", cfg_path, "--data", data, "--model_dir", out,
                    "--device", "cpu"])
    assert res["epochs"] == 3 and res["val_images"] == 4 and res["train_images"] == 44
    assert res["steps"] == 3 * (44 // 8)
    rows = open(os.path.join(out, "history.csv")).read().split()
    assert rows[0] == "epoch,loss,val_loss" and len(rows) == 4
    val = [float(r.split(",")[2]) for r in rows[1:]]
    assert res["best_val_mse"] == pytest.approx(min(val)) and res["best_epoch"] == int(
        np.argmin(val))
    assert io_utils.load_yaml(os.path.join(out, "config.yaml")) == TINY
    mse = tte.main(["test", "--data", data, "--model_dir", out, "--device", "cpu"])
    with torch.no_grad():
        model = tte.load_trained_autoencoder(out)
        ref = float(((model(torch.as_tensor(x[48:])) - torch.as_tensor(x[48:])) ** 2).mean())
    assert mse == pytest.approx(ref, rel=1e-5) and 0 < mse < float((x[48:] ** 2).mean()) * 2
    # no gain at lr 0: early stopping after PATIENCE epochs, weights of epoch 0
    monkeypatch.setattr(tte, "PATIENCE", 2)
    io_utils.save_yaml(dict(TINY, learning_rate=0.0, epochs=10), cfg_path)
    res = tte.main(["train", "--config", cfg_path, "--data", data, "--model_dir", out,
                    "--device", "cpu"])
    assert res["epochs"] == 3 and res["best_epoch"] == 0


# ------------------------------------------------------------------ (g)

def _collect_config():
    cfg = jcfg.load_config(os.path.join(REPO, "tests", "configs", "test_continuous.yaml"))
    cfg["tpu"].update(max_objects=3, gripper_substeps=4, move_substeps=2, solver_iterations=1,
                      pad_inner_iterations=1)
    return cfg


@pytest.fixture(scope="module")
def collect_states():
    """4 JAX-built OnTable tray states at lambda 1, grippers lowered over
    the objects so that they fill the view, and the port's env."""
    cfg = _collect_config()
    je = jenv.GraspEnv(cfg)
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    js = jax.jit(jax.vmap(lambda k: je.reset_env(k, 1.0, settle_substeps=0)))(keys)
    q = np.array(js.sim.gripper.q)
    q[:, :2] = np.asarray(js.sim.objects.pos)[:, 0, :2]
    q[:, 2] = np.asarray([0.08, 0.12, 0.16, 0.2])
    q[:, 3] = 0.0
    js = js.replace(sim=js.sim.replace(gripper=js.sim.gripper.replace(q=jnp.asarray(q))))
    env = tcollect.collect_env(cfg, keep_task=True, device="cpu")
    return je, js, env


def _flat(s):
    """A JAX env state as the flat numpy arrays `env_state_from_numpy` reads."""
    import dataclasses

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


def _masked(env, js):
    return tcollect.masked_depth(env, tenv.env_state_from_numpy(_flat(js))).numpy()


def _close(got, ref):
    off = np.abs(got - ref) > 1e-4
    assert off.mean() <= 1e-3, f"{off.sum()} pixels differ by more than 1e-4"
    assert (ref > 0).mean() > 0.02 and (ref == 0).mean() > 0.2  # objects kept, the rest masked


def test_masked_depth_matches_jax_at_zero_yaw(collect_states):
    je, js, env = collect_states
    ref = np.asarray(jax.vmap(lambda s: jcollect.masked_depth(je, s))(js))
    _close(_masked(env, js), ref)


def test_masked_depth_matches_the_pallas_raster_when_yawed(collect_states):
    je, js, env = collect_states
    q = np.array(js.sim.gripper.q)
    q[:, 3] = np.asarray([-2.5, -0.8, 0.9, 2.7])
    js = js.replace(sim=js.sim.replace(gripper=js.sim.gripper.replace(q=jnp.asarray(q))))
    cam_pos, cam_R = jax.vmap(jraycast.camera_pose_from_gripper)(js.sim.gripper.q, js.cam_t,
                                                                js.cam_R)
    depth, seg = render_batch_pallas(js.sim, je.sim_params, cam_pos, cam_R, js.intrinsics,
                                     H=je.im_h, W=je.im_w, near=je.near, far=je.far,
                                     interpret=True)
    gripper_id = je.max_slots + 3  # OnTable: plane 0, table 1, tray 2, objects 3..
    drop = (seg == 0) | (seg == gripper_id) | (seg == 1) | (seg == 2)
    ref = np.asarray(jnp.where(drop, 0.0, depth))
    _close(_masked(env, js), ref)
    # the JAX collector's XLA render hides object pixels otherwise here: the
    # pads turn the other way (seen: 23 pixels, all in the env yawed 0.9)
    xla = np.asarray(jax.vmap(lambda s: jcollect.masked_depth(je, s))(js))
    assert 0 < int((np.abs(xla - ref) > 1e-4).sum()) < 1e-2 * ref.size


# ------------------------------------------------------------------ (h)

def test_collect_writes_the_dataset(tmp_path):
    imgs = tcollect.collect(_collect_config(), 6, num_envs=2, steps_per_reset=2, keep_task=True,
                            mix_lambda=True, device="cpu")
    assert imgs.shape == (6, 64, 64) and bool(torch.isfinite(imgs).all())
    assert float(imgs.min()) >= 0.0 and 0.0 < float((imgs > 0).float().mean()) < 1.0
    cfg_path = str(tmp_path / "cfg.yaml")
    io_utils.save_yaml(_collect_config(), cfg_path)
    out = str(tmp_path / "ds.npz")
    res = tcollect.main(["--config", cfg_path, "--out", out, "--train", "3", "--test", "1",
                         "--num_envs", "2", "--device", "cpu"])
    with np.load(out) as f:
        assert f["train"].shape == (3, 64, 64, 1) and f["test"].shape == (1, 64, 64, 1)
        assert f["train"].dtype == f["test"].dtype == np.float32
    assert res["images"] == 4


def test_committed_port_encoder_loads_in_jax():
    """`encoder_files/full_torch_r1`, trained by the port on the card: the
    JAX package's loader reads its weights.npz unedited and encodes as the
    port's loader does, at bf16 tolerance."""
    path = os.path.join(REPO, "encoder_files", "full_torch_r1")
    encode_fn, _ = jte.load_trained_encoder(path)
    x = images(8, seed=9)
    z_ref = np.stack([np.asarray(encode_fn(jnp.asarray(img))) for img in x])
    with torch.no_grad():
        z = tte.load_trained_encoder(path)(torch.as_tensor(x)).numpy()
    assert z.shape == (8, 100)
    np.testing.assert_allclose(z, z_ref, atol=TOL, rtol=0)
    assert np.abs(z_ref).max() > 0.5
