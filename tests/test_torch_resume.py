"""Resume, replay-ring snapshots and policy-bundle export in the port vs the
JAX package, on the CPU at a tiny size.

(a) `replay.snapshot` / `restore_snapshot` against the JAX package's on
    the same prioritized ring (stride 4, capacity 32, numpy-made rows and
    priorities): a ring that wrapped (as tests/test_replay_normalize.py:205)
    and a partly filled one (size < rows, :238); every column, `n`, the
    write pointer and the fill count equal bit for bit, the seam's rows
    marked done, and the n-step rows gathered after the restore equal to
    those of the JAX buffer. A snapshot that does not fit is refused.
(b) `train` then `train --load_dir` for SAC (the RGB-D flagship, CNN torso)
    and BDQ (the simplified task, prioritized), cut as
    tests/test_torch_training.py cuts its run (2 envs, 16 hidden units,
    `time_horizon` 3, a 16-row ring snapshot). A resume that runs no
    further frame (demo seeding off) writes back exactly what it restored:
    params, target params, the Adam moments and counts, SAC's log_alpha,
    the normalizer moments, the curriculum, the frame count, and the ring's
    rows with their priorities, the seam's rows now done. A resume that
    trains on continues the frame count, the update count and the run log.
    A resume with another `num_envs` skips the ring with a warning and
    trains; one into its own directory restores its own snapshot.
(c) Bundles written by `policy_io.save_policy` for a SAC actor (CNN
    torso), a dueling DQN and a BDQ (MLP torsos), at tiny width, read by
    the JAX package's `policy_io.load_policy` into the Flax modules: the
    outputs agree at the bf16 tolerances of tests/test_torch_networks.py
    (5e-2 absolute + relative) and tests/test_torch_discrete.py (Q values
    to 2e-2), greedy actions agree wherever no rounding can swap them, the
    moments are equal, and the port reads the same weights back exactly. A
    bundle whose arrays drifted in shape fails loudly in both packages, and
    the committed bundles, read and written back, come out bit for bit.
    `tools/export_policy` of the trained runs writes a bundle the port's
    `run --npz` evaluates and the JAX loader reads.
"""

import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu.algos import normalize as jnorm
from deep_rl_grasping_tpu.algos import replay as jreplay
from deep_rl_grasping_tpu.models import networks as jnet
from deep_rl_grasping_tpu.utils import policy_io as jpolicy_io
from deep_rl_grasping_tpu_torch.algos import normalize as tnorm
from deep_rl_grasping_tpu_torch.algos import replay as treplay
from deep_rl_grasping_tpu_torch.models import networks as tnet
from deep_rl_grasping_tpu_torch.tools import export_policy
from deep_rl_grasping_tpu_torch.training import callbacks as cb
from deep_rl_grasping_tpu_torch.training import train
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils, policy_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDE, CAPACITY, OBS = 4, 32, (3,)
COLUMNS = ("obs", "action", "reward", "done", "priority")


# ------------------------------------------------------------------ (a)

def _buffers(n_batches):
    """A JAX and a port prioritized ring after the same inserts and
    priority updates."""
    rng = np.random.default_rng(7)
    jb = jreplay.create(CAPACITY, OBS, (3,), STRIDE, action_dtype=jnp.int32)
    tb = treplay.create(CAPACITY, OBS, (3,), STRIDE, action_dtype=torch.int32)
    for i in range(n_batches):
        obs = rng.normal(size=(STRIDE,) + OBS).astype(np.float32)
        act = rng.integers(0, 8, (STRIDE, 3)).astype(np.int32)
        rew = rng.normal(size=STRIDE).astype(np.float32)
        done = rng.random(STRIDE) < 0.25
        jb = jreplay.insert(jb, jnp.asarray(obs), jnp.asarray(act), jnp.asarray(rew),
                            jnp.asarray(done))
        treplay.insert(tb, torch.as_tensor(obs), torch.as_tensor(act), torch.as_tensor(rew),
                       torch.as_tensor(done))
        idx = rng.choice(min((i + 1) * STRIDE, CAPACITY), 3, replace=False)
        td = rng.uniform(0.0, 3.0, 3).astype(np.float32)
        jb = jreplay.update_priorities(jb, jnp.asarray(idx, jnp.int32), jnp.asarray(td))
        treplay.update_priorities(tb, torch.as_tensor(idx), torch.as_tensor(td))
    return jb, tb


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


@pytest.mark.parametrize("n_batches,rows,n", [(11, 16, 16), (11, 18, 16), (1, 16, 4)],
                         ids=["wrapped", "rows_rounded_to_stride", "partial_fill"])
def test_snapshot_and_restore_match_jax(n_batches, rows, n):
    jb, tb = _buffers(n_batches)
    jsnap, tsnap = jreplay.snapshot(jb, rows), treplay.snapshot(tb, rows)
    assert int(jsnap["n"]) == tsnap["n"] == n and tsnap["batch_stride"] == STRIDE
    for k in COLUMNS:
        assert tsnap[k].device.type == "cpu"
        np.testing.assert_array_equal(_np(tsnap[k]), _np(jsnap[k]), err_msg=k)
    assert len(set(_np(tsnap["priority"]).tolist())) > 3  # real priorities travel
    jr = jreplay.restore_snapshot(
        jreplay.create(CAPACITY, OBS, (3,), STRIDE, action_dtype=jnp.int32), jsnap)
    tr = treplay.restore_snapshot(
        treplay.create(CAPACITY, OBS, (3,), STRIDE, action_dtype=torch.int32), tsnap)
    assert (tr.ptr, tr.size) == (int(jr.ptr), int(jr.size)) == (16, n)
    for k in COLUMNS:
        np.testing.assert_array_equal(_np(getattr(tr, k)), _np(getattr(jr, k)), err_msg=k)
    assert tr.done[16 - STRIDE:16].all()
    # the n-step rows gathered after the restore stop at the seam in both
    jbatch = jreplay.sample(jr, jax.random.PRNGKey(3), 24, n_step=2, gamma=0.9)
    idx = torch.as_tensor(np.array(jbatch["idx"]), dtype=torch.int64)
    tbatch = treplay.gather(tr, torch.remainder(idx - (tr.ptr - tr.size), tr.capacity),
                            n_step=2, gamma=0.9)
    for k in ("obs", "action", "reward", "done", "discount", "next_obs", "idx"):
        np.testing.assert_array_equal(_np(tbatch[k]), _np(jbatch[k]), err_msg=k)


def test_restore_refuses_a_snapshot_that_does_not_fit():
    _, tb = _buffers(11)
    snap = treplay.snapshot(tb, 16)
    with pytest.raises(ValueError, match="incompatible"):
        treplay.restore_snapshot(treplay.create(8, OBS, (3,), STRIDE), snap)
    with pytest.raises(ValueError, match="incompatible"):
        treplay.restore_snapshot(treplay.create(30, OBS, (3,), 6), snap)


def test_ring_checkpointer_keeps_one(tmp_path):
    ring = cb.RingCheckpointer(str(tmp_path))
    assert ring.restore_raw() is None and not os.path.exists(tmp_path / "ring")
    _, tb = _buffers(3)
    for step in (4, 8):
        ring.save(step, treplay.snapshot(tb, step))
    assert os.listdir(tmp_path / "ring") == ["ckpt_8.pt"] and ring.latest_step() == 8
    got = cb.RingCheckpointer(str(tmp_path)).restore_raw()
    assert got["n"] == 8 and torch.equal(got["priority"], treplay.snapshot(tb, 8)["priority"])


# ------------------------------------------------------------------ (b)

FRAMES, MORE = 16, 24  # frames of the first run; the resumed run's target


def _tiny_config(algo):
    if algo == "SAC":
        cfg = cfg_util.load_config(os.path.join(REPO, "configs", "sac_rgbd_flagship.yaml"))
        cfg["tpu"].update(max_objects=3, gripper_substeps=2, solver_iterations=1,
                          pad_inner_iterations=1, demo_capacity=16, recent_window=8)
        cfg["SAC"].update(batch_size=8, buffer_size=64, learning_starts=8, layers=[16, 16])
        cfg["curriculum"].update(window_size=2, success_threshold=-1.0)
    else:
        cfg = cfg_util.load_config(os.path.join(REPO, "configs", "bdq_simplified.yaml"))
        cfg["tpu"].update(max_objects=2, move_substeps=1, gripper_substeps=2,
                          solver_iterations=1, pad_inner_iterations=1)
        cfg["BDQ"].update(batch_size=4, buffer_size=32, learning_starts=4,
                          layers=[[16], [8], [8]])
    cfg["tpu"].update(num_envs=2, updates_per_step=2, demo_frames=8, demo_refresh_every=8,
                      demo_refresh_frames=4, eval_freq=8, checkpoint_freq=4, chunk_steps=2,
                      ring_checkpoint_rows=16, ring_checkpoint_every=12)
    cfg[algo]["total_timesteps"] = FRAMES
    cfg["time_horizon"] = 3
    cfg["algorithm"] = algo.lower()
    return cfg


def _train(cfg, root, name, *extra):
    path = os.path.join(root, f"{name}.yaml")
    io_utils.save_yaml(cfg, path)
    return train.main(["train", "--config", path, "--algo", cfg["algorithm"], "--model_dir",
                       os.path.join(root, name), "--device", "cpu", "--seed", "2", *extra])


def _equal(a, b, where=""):
    """Recursive exact equality of checkpoint payloads."""
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


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per learner, built on first use: the first run, a resume that trains
    no further frame (demo seeding off, so that nothing but the restore
    touches the state it saves) and a resume that trains on."""
    made = {}

    def get(algo):
        if algo not in made:
            root = str(tmp_path_factory.mktemp(f"resume_{algo}"))
            cfg = _tiny_config(algo)
            first = _train(cfg, root, "a")
            quiet = dict(cfg, tpu=dict(cfg["tpu"], demo_frames=0, demo_fraction=0,
                                       demo_refresh_every=0))
            again = _train(quiet, root, "c", "--load_dir", os.path.join(root, "a"),
                           "--timestep", str(FRAMES))
            more = _train(cfg, root, "b", "--load_dir", os.path.join(root, "a"),
                          "--timestep", str(MORE))
            made[algo] = (algo, root, first, again, more)
        return made[algo]
    return get


ALGOS = pytest.mark.parametrize("algo", ["SAC", "BDQ"])


@ALGOS
def test_resume_restores_every_saved_field(runs, algo):
    algo, root, first, again, _ = runs(algo)
    assert first["frames"] == FRAMES and first["done"]
    assert again["resume_frames"] == FRAMES and again["frames"] == FRAMES
    saved = cb.Checkpointer(os.path.join(root, "a")).restore()
    written = cb.Checkpointer(os.path.join(root, "c"))
    assert written.latest_step() == FRAMES  # named by the restored frame count
    # learner (params, targets, Adam moments and counts, log_alpha),
    # normalizer moments and curriculum, as saved
    _equal(written.restore(), saved)
    keys = ({"actor", "critic", "target_critic", "log_alpha", "actor_opt", "critic_opt",
             "alpha_opt", "step"} if algo == "SAC" else {"net", "target_net", "opt", "step"})
    assert set(saved["algo_state"]) == keys and saved["algo_state"]["step"] > 0
    opt = saved["algo_state"]["critic_opt" if algo == "SAC" else "opt"]["state"]
    assert all(float(s["step"]) > 0 and float(s["exp_avg_sq"].abs().sum()) > 0
               for s in opt.values())
    # the ring: the newest rows with their priorities, the seam now done
    snap_a = cb.RingCheckpointer(os.path.join(root, "a")).restore_raw()
    snap_c = cb.RingCheckpointer(os.path.join(root, "c")).restore_raw()
    assert again["ring_rows_restored"] == snap_a["n"] == min(first["replay_rows"], 16)
    assert snap_c["n"] == snap_a["n"]
    for k in ("obs", "action", "reward", "priority"):
        assert torch.equal(snap_c[k], snap_a[k]), k
    assert torch.equal(snap_c["done"][:-2], snap_a["done"][:-2]) and snap_c["done"][-2:].all()
    if algo == "BDQ":
        assert (snap_a["priority"] != 1.0).any()  # prioritized updates wrote |TD|


@ALGOS
def test_resume_continues_the_run(runs, algo):
    algo, root, first, _, more = runs(algo)
    assert more["resume_frames"] == FRAMES and more["frames"] == MORE and more["done"]
    assert more["ring_rows_restored"] == min(first["replay_rows"], 16)
    with open(os.path.join(root, "b", "logs.csv")) as f:
        steps = [int(ln.split(",")[0]) for ln in f.read().splitlines()[1:]]
    assert steps == [20, 24]
    # the update count goes on from the checkpoint's
    assert more["updates"] == first["updates"] + 2 * 2 * 2
    # evaluations keep their cadence (every 8 frames: 8, 16 | 24)
    with open(os.path.join(root, "b", "eval_logs.csv")) as f:
        assert [int(ln.split(",")[0]) for ln in f.read().splitlines()[1:]] == [24]
    with open(os.path.join(root, "b", "runs.jsonl")) as f:
        runs = [json.loads(ln) for ln in f]
    assert [(r["start_frames"], r["frames"], r["load_dir"]) for r in runs] == [
        (0, FRAMES, None), (FRAMES, MORE, os.path.join(root, "a"))]
    assert runs[1]["command"].endswith(f"--load_dir {os.path.join(root, 'a')} --timestep {MORE}")


def test_resume_skips_a_mismatched_ring(runs, tmp_path, caplog):
    algo, root, first, *_ = runs("BDQ")
    cfg = _tiny_config(algo)
    cfg["tpu"]["num_envs"] = 4
    with caplog.at_level(logging.WARNING):
        res = _train(cfg, str(tmp_path), "wide", "--load_dir", os.path.join(root, "a"),
                     "--timestep", str(MORE))
    assert "does not match this run (stride 4" in caplog.text
    assert res["ring_rows_restored"] is None and res["resume_frames"] == FRAMES
    assert res["frames"] == MORE and res["done"]


def test_resume_into_its_own_directory(runs, tmp_path):
    algo, root, first, *_ = runs("BDQ")
    run = str(tmp_path / "a")
    shutil.copytree(os.path.join(root, "a"), run)
    cfg = _tiny_config(algo)
    res = _train(cfg, str(tmp_path), "a", "--load_dir", run, "--timestep", str(MORE))
    assert res["ring_rows_restored"] == min(first["replay_rows"], 16)
    assert res["frames"] == MORE and cb.Checkpointer(run).latest_step() == MORE
    with open(os.path.join(run, "runs.jsonl")) as f:
        assert len(f.read().splitlines()) == 2


# ------------------------------------------------------------------ (c)

ATOL = RTOL = 5e-2
Q_TOL = 2e-2


def _module(kind):
    """(torch module, Flax module, observation shape) at tiny width."""
    torch.manual_seed(4)
    if kind == "SAC":
        obs = (44, 52, 3)
        return tnet.SACActor(obs, 5, (16, 16), image_obs=True), jnet.SACActor(5, (16, 16), True), obs
    if kind == "DQN":
        return tnet.QNetwork((20,), 6, (16, 16)), jnet.QNetwork(6, (16, 16), False, True), (20,)
    return (tnet.BDQNetwork((20,), 3, 4, (16,), (8,), (8,)),
            jnet.BDQNetwork(3, 4, (16,), (8,), (8,)), (20,))


def _rms(shape, rng):
    return tnorm.RunningMeanStd(mean=torch.as_tensor(rng.normal(size=shape), dtype=torch.float32),
                                var=torch.as_tensor(rng.uniform(0.5, 2, shape),
                                                    dtype=torch.float32),
                                count=torch.tensor(123.0))


def _greedy_agree(q_t, q_f):
    top2 = np.sort(q_f, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * np.abs(q_t - q_f).max()
    np.testing.assert_array_equal(q_t.argmax(-1)[clear], q_f.argmax(-1)[clear])
    return int(clear.sum())


@pytest.mark.parametrize("kind", ["SAC", "DQN", "BDQ"])
def test_bundle_round_trip_through_jax(kind, tmp_path):
    net, fnet, obs_shape = _module(kind)
    rng = np.random.default_rng(9)
    with torch.no_grad():  # weights away from the init's scale
        for p in net.parameters():
            p.add_(0.1 * torch.randn_like(p))
    obs_rms, ret_rms = _rms(obs_shape, rng), _rms((), rng)
    policy_io.save_policy(str(tmp_path), net, obs_rms, ret_rms, dict(source="test"))
    template = fnet.init(jax.random.PRNGKey(0), jnp.zeros((1,) + obs_shape))["params"]
    params, jobs, jret, meta = jpolicy_io.load_policy(
        str(tmp_path), template, jnorm.RunningMeanStd.init(obs_shape), jnorm.RunningMeanStd.init(()))
    assert meta == {"algo": kind, "params_field": "actor_params" if kind == "SAC" else "params",
                    "format_version": 1, "source": "test"}
    for mine, theirs in ((obs_rms, jobs), (ret_rms, jret)):
        for k in ("mean", "var", "count"):
            np.testing.assert_array_equal(getattr(mine, k).numpy(), np.asarray(getattr(theirs, k)))
    obs = rng.normal(size=(48,) + obs_shape).astype(np.float32)
    out_f = fnet.apply({"params": params}, jnp.asarray(obs))
    with torch.no_grad():
        out_t = net(torch.as_tensor(obs))
    if kind == "SAC":
        for t, f in zip(out_t, out_f):
            np.testing.assert_allclose(t.numpy(), np.asarray(f), atol=ATOL, rtol=RTOL)
        # the greedy action, tanh of the mean
        np.testing.assert_allclose(np.tanh(out_t[0].numpy()), np.tanh(np.asarray(out_f[0])),
                                   atol=ATOL, rtol=0)
        assert np.ptp(np.asarray(out_f[0])) > 0.1
    else:
        q_t, q_f = out_t.numpy(), np.asarray(out_f)
        np.testing.assert_allclose(q_t, q_f, atol=Q_TOL, rtol=0)
        assert _greedy_agree(q_t, q_f) > 0 and np.ptp(q_f) > 0.1
    # the port reads the very same weights back
    back = _module(kind)[0]
    policy_io.load_policy(str(tmp_path), back)
    _equal(back.state_dict(), net.state_dict())


@pytest.mark.parametrize("bundle", ["sac_full_flagship_r5c", "sac_encoder_flagship_r5",
                                    "dqn_simplified_r5", "bdq_simplified_r5",
                                    "bdq_simplified_torch_r1", "dqn_simplified_torch_r1"])
def test_reexport_reproduces_the_committed_bundle(bundle, tmp_path):
    """Read by the port and written back by `save_policy`, a committed
    bundle's arrays come out bit for bit (the CNN's flatten order too)."""
    path = os.path.join(REPO, "trained", bundle)
    _, policy, norm = train.load_bundle_actor(path, "cpu")
    net = policy if isinstance(policy, tnet.SACActor) else policy.net
    policy_io.save_policy(str(tmp_path), net, norm.obs_rms, norm.ret_rms)
    want, got = np.load(os.path.join(path, "policy.npz")), np.load(tmp_path / "policy.npz")
    assert set(want.files) == set(got.files)
    for k in want.files:
        if k != "__meta__":
            assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k


def test_shape_drifted_bundle_fails_loudly(tmp_path):
    net, fnet, obs_shape = _module("DQN")
    rng = np.random.default_rng(1)
    policy_io.save_policy(str(tmp_path), net, _rms(obs_shape, rng), _rms((), rng))
    data = dict(np.load(tmp_path / "policy.npz"))
    key = "policy['Dense_1']['kernel']"
    data[key] = np.zeros((17, 64), np.float32)
    np.savez(tmp_path / "policy.npz", **data)
    template = fnet.init(jax.random.PRNGKey(0), jnp.zeros((1,) + obs_shape))["params"]
    with pytest.raises(ValueError, match="shape"):
        jpolicy_io.load_policy(str(tmp_path), template, jnorm.RunningMeanStd.init(obs_shape),
                               jnorm.RunningMeanStd.init(()))
    with pytest.raises(ValueError, match="adv_hidden"):
        policy_io.load_policy(str(tmp_path), _module("DQN")[0])


@ALGOS
def test_exported_run_evaluates_in_both_packages(runs, algo, tmp_path):
    algo, root, *_ = runs(algo)
    run = os.path.join(root, "b")
    out = str(tmp_path / "bundle")
    info = export_policy.main([run, "--out", out, "--latest", "--device", "cpu"])
    assert info["checkpoint_step"] == MORE and info["source"] == "latest"
    assert sorted(os.listdir(out)) == ["PROVENANCE.md", "config.yaml", "policy.npz"]
    assert io_utils.load_yaml(os.path.join(out, "config.yaml")) == io_utils.load_yaml(
        os.path.join(run, "config.yaml"))
    with open(os.path.join(out, "PROVENANCE.md")) as f:
        prov = f.read()
    assert "2 `train` call(s), 1 of them resumed" in prov and f"frames {FRAMES} -> {MORE}" in prov
    # the bundle holds the checkpoint's policy exactly
    _, policy, _ = train.load_checkpoint_actor(run, "cpu")
    _, from_bundle, _ = train.load_bundle_actor(out, "cpu")
    net = policy if algo == "SAC" else policy.net
    _equal((from_bundle if algo == "SAC" else from_bundle.net).state_dict(), net.state_dict())
    res = train.main(["run", "--npz", out, "--episodes", "2", "--device", "cpu"])
    assert res["episodes"] == 2 and np.isfinite(res["mean_return"])
    # the JAX loader takes it into the Flax module of the config
    cfg = io_utils.load_yaml(os.path.join(out, "config.yaml"))
    if algo == "SAC":
        fnet, shape = jnet.SACActor(5, (16, 16), True), (64, 64, 5)
    else:
        fnet, shape = jnet.BDQNetwork(3, 8, (16,), (8,), (8,)), (100,)
    assert cfg["algorithm"] == algo.lower()
    template = fnet.init(jax.random.PRNGKey(0), jnp.zeros((1,) + shape))["params"]
    jpolicy_io.load_policy(out, template, jnorm.RunningMeanStd.init(shape),
                           jnorm.RunningMeanStd.init(()))


def test_entry_points_refuse_what_they_cannot_honour(tmp_path):
    """`tools/export_policy` runs on the card unless told otherwise, and
    `run --scenes` takes one episode per stored scene."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            export_policy.main([str(tmp_path)])
    scenes = os.path.join(REPO, "deep_rl_grasping_tpu_torch", "data",
                          "simplified_r5_val_scenes.npz")
    with pytest.raises(SystemExit, match="holds 100 scenes, not 50"):
        train.main(["run", "--npz", os.path.join(REPO, "trained", "bdq_simplified_r5"),
                    "--scenes", scenes, "--episodes", "50", "--device", "cpu"])
