"""The port's data-parallel trainer (parallel/train_dp.py) vs the JAX
package's, on the CPU: gloo process groups, spawned ranks on a file store.

(a) One update of SAC, DQN, BDQ and DDPG at world 2, each rank on its own
    half of a numpy-made batch (SAC with its own normal draws, reproduced
    from the per-device keys as tests/test_torch_algos.py does): the new
    parameters are equal on both ranks bit for bit, and equal to the JAX
    learner's with `pmean_axis="env"` under shard_map on two devices, at
    the one-update tolerance of tests/test_torch_algos.py (float32
    networks in both packages; 1e-6 on all but 0.5% of the parameters and
    2 x the learning rate everywhere: Adam's first step is lr * g / (|g| +
    eps), so a gradient within rounding of zero can flip a step's sign;
    target networks and log_alpha to 1e-6 and 1e-7).
(b) The curriculum window over the masks of both ranks, gathered in rank
    order, against the JAX `curriculum.update` on the all-gathered masks,
    bit for bit, over streams in which more episodes end in one step than
    the window holds. The collectives themselves on known values: the
    mean (a sum / world; Adam's step is blind to the gradient's scale, so
    (a) could not tell a sum from a mean), the gather's rank order, the
    sum, the stop flag and the broadcast of rank 0's values and learner.
(c) World 1 is the single-device trainer: a one-rank `ShardedTrainer` and
    the plain `Trainer`, from the same seed and learner, give the same
    learner, curriculum, replay and metrics bit for bit after demo seeding
    and two iterations.
(d) A tiny world-2 `train` (the sharded quality config cut to 4 envs, 16
    hidden units, 3-step episodes) stopped by a SIGTERM to rank 1 alone:
    both ranks stop at the same chunk within a timeout and save; every
    learner leaf and the curriculum are equal across ranks, the env states
    and the generators differ, each rank seeded half the demo frames and
    the logged counts are the sum, frames = world x the rank's step, and
    the monitor holds every rank's episodes. Its checkpoint resumes into a
    world-1 run, whose checkpoint resumes into a world-2 run. The
    observation normalizer stays per rank, and the checkpoint carries rank
    0's; `tools/normalizer_probe.py` merges two ranks' moments.
(e) The JAX fault the port does not copy: the learners the JAX trainer
    builds from the two devices' split keys (train.py:121-122,
    `_init_local`, trainer.py:333-344) differ in every kernel.
"""

import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from deep_rl_grasping_tpu.algos import bdq as jbdq
from deep_rl_grasping_tpu.algos import ddpg as jddpg
from deep_rl_grasping_tpu.algos import dqn as jdqn
from deep_rl_grasping_tpu.algos import sac as jsac
from deep_rl_grasping_tpu.envs import curriculum as jcurr
from deep_rl_grasping_tpu.models import networks as jnet
from deep_rl_grasping_tpu_torch.algos import sac as tsac
from deep_rl_grasping_tpu_torch.algos.normalize import RunningMeanStd
from deep_rl_grasping_tpu_torch.algos.bdq import BDQ
from deep_rl_grasping_tpu_torch.algos.ddpg import DDPG
from deep_rl_grasping_tpu_torch.algos.dqn import DQN
from deep_rl_grasping_tpu_torch.envs import curriculum as tcurr
from deep_rl_grasping_tpu_torch.envs.grasp_env import fold_episodes
from deep_rl_grasping_tpu_torch.models import networks as tnet
from deep_rl_grasping_tpu_torch.parallel import train_dp
from deep_rl_grasping_tpu_torch.tools import normalizer_probe
from deep_rl_grasping_tpu_torch.training import callbacks as cb
from deep_rl_grasping_tpu_torch.training.trainer import Trainer
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils, policy_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDED = os.path.join(REPO, "configs", "sac_simplified_sharded_quality.yaml")
CPUS = ["cpu", "cpu"]
JOIN_TIMEOUT = 240
N, A = 16, 5  # rows per rank, SAC / DDPG action width
CURR_FIELDS = ("lam", "ring", "ptr", "filled", "sr_mean", "policy_iteration")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One thread here and in every spawned rank (they read the variable)."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), dict(tree))


def _jitter(tree, rng, scale=0.02):
    return jax.tree.map(lambda p: p + scale * rng.standard_normal(p.shape).astype(np.float32),
                        tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _assert_same(a, b):
    """Two nested payloads equal bit for bit, leaf by leaf."""
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for k, v in la.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == lb[k].dtype and torch.equal(v, lb[k]), k
        else:
            assert v == lb[k], k


# ---------------------------------------------------------------- (a), (b)

SAC_CFG = {"discount_factor": 0.99,
           "SAC": {"layers": [16, 16], "batch_size": N, "step_size": 3e-4,
                   "target_entropy": 0.0, "q_clip": [-0.5, 0.5], "bc_weight": 2.0},
           "tpu": {"demo_fraction": 0.25}}
DDPG_CFG = {"discount_factor": 0.99,
            "DDPG": {"layers": [16, 16], "actor_lr": 1e-3, "critic_lr": 2e-3, "tau": 0.05,
                     "batch_size": N}}
Q_BLOCKS = {"DQN": ({"layers": [16, 16], "learning_rate": 1e-3}, 6, ()),
            "BDQ": ({"layers": [[16, 16], [8], [8]], "learning_rate": 1e-3,
                     "num_actions_pad": 4}, 4, (3,))}
OBS = (101,)


def _q_cfg(algo):
    return {"discount_factor": 0.99, algo: dict(Q_BLOCKS[algo][0], target_network_update_freq=1)}


def _batches(rng, action):
    """Two ranks' batches, stacked: (2, N, ...) per column."""
    done = rng.random((2, N)) < 0.3
    batch = dict(obs=rng.normal(size=(2, N) + OBS).astype(np.float32),
                 next_obs=rng.normal(size=(2, N) + OBS).astype(np.float32),
                 action=action, reward=rng.normal(0.0, 0.3, (2, N)).astype(np.float32),
                 done=done, discount=(0.99 ** 3 * ~done).astype(np.float32),
                 weight=rng.uniform(0.2, 1.0, (2, N)).astype(np.float32))
    return batch


def _port_learner(name, job):
    """The port's learner of a job, holding the job's JAX parameters."""
    if name == "SAC":
        algo = tsac.SAC(OBS, A, SAC_CFG, device="cpu")
        return policy_io.load_sac_state(algo, *job["params"])
    if name == "DDPG":
        algo = DDPG(OBS, A, DDPG_CFG)
        for net, tree in zip(("actor", "critic", "target_actor", "target_critic"), job["params"]):
            policy_io.load_flax_params(getattr(algo, net), tree)
        return algo
    cls = {"DQN": lambda c: DQN(OBS, 6, c, "cpu"), "BDQ": lambda c: BDQ(OBS, 3, c, "cpu")}[name]
    return policy_io.load_q_state(cls(_q_cfg(name)), *job["params"])


def _update_worker(rank, device, jobs):
    """One rank of (a) and (b): each learner's update on this rank's half,
    its gradients averaged over the ranks; the curriculum over both ranks'
    masks."""
    torch.set_num_threads(1)
    tnet.CDTYPE = torch.float32
    dp = train_dp.DataParallel(device)
    out = {}
    for name, job in jobs.items():
        if name == "collectives":
            x, y = torch.full((3,), rank + 1.0), torch.arange(4.0).reshape(2, 2) * (rank + 1)
            b = torch.full((2,), float(rank))
            dp.broadcast_([b])
            torch.manual_seed(rank)  # each rank's learner starts apart
            learner = DDPG(OBS, A, DDPG_CFG)
            train_dp.broadcast_learner(dp, learner)
            out[name] = dict(mean=dp.mean([x, y]), sum=dp.sum(torch.tensor([rank + 1.0])),
                             gather=dp.gather(torch.tensor([[rank, 10.0 + rank]])),
                             any_one=dp.any(rank == 1), any_none=dp.any(False), broadcast=b,
                             learner=learner.state_dict())
            continue
        if name == "curriculum":
            spec = tcurr.CurriculumSpec.from_config(job["config"])
            state, steps = tcurr.CurriculumState.init(spec), []
            for done, succ in zip(job["done"][rank], job["succ"][rank]):
                state = fold_episodes(spec, state, torch.as_tensor(done), torch.as_tensor(succ), dp)
                steps.append({f: getattr(state, f).clone() for f in CURR_FIELDS})
            out[name] = steps
            continue
        algo = _port_learner(name, job)
        algo.grad_mean = dp.mean
        batch = {k: torch.as_tensor(v[rank]) for k, v in job["batch"].items()}
        if name == "SAC":
            algo.update(batch, noise=tuple(torch.as_tensor(n[rank]) for n in job["noise"]))
        else:
            algo.update(batch)
        out[name] = {k: v.detach().clone() for k, v in _leaves(algo.state_dict()).items()
                     if isinstance(v, torch.Tensor)}
    return out


def _shard_update(jalgo, with_key):
    """JAX's update under shard_map on two devices, pmean over 'env': the
    state replicated, the batch (and the keys) split."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("env",))
    if with_key:
        local = lambda s, b, k: jalgo.update(s, b, k[0])[0]
        specs = (P(), P("env"), P("env"))
    else:
        local = lambda s, b: jalgo.update(s, b)[0]
        specs = (P(), P("env"))
    return jax.jit(shard_map(local, mesh=mesh, in_specs=specs, out_specs=P(), check_vma=False))


@pytest.fixture(scope="module")
def parity():
    """The JAX updates and the jobs for the ranks; then the ranks' results."""
    rng = np.random.default_rng(21)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnet, "CDTYPE", jnp.float32)
        jobs, want = {}, {}
        flat = lambda b: {k: jnp.asarray(v.reshape((2 * N,) + v.shape[2:])) for k, v in b.items()}

        jalgo = jsac.SAC(OBS, A, SAC_CFG, pmean_axis="env")
        st = jalgo.init(jax.random.PRNGKey(0))
        st = st.replace(actor_params=_jitter(st.actor_params, rng),
                        target_critic_params=_jitter(st.critic_params, rng),
                        log_alpha=jnp.asarray(-0.5, jnp.float32))
        batch = _batches(rng, rng.uniform(-0.9, 0.9, (2, N, A)).astype(np.float32))
        batch["is_demo"] = np.tile(np.arange(N) >= N - 4, (2, 1))
        keys = jax.random.split(jax.random.PRNGKey(9), 2)
        want["SAC"] = _shard_update(jalgo, True)(st, flat(batch), keys)
        noise = [[np.asarray(jax.random.normal(k, (N, A))) for k in jax.random.split(key)]
                 for key in keys]
        jobs["SAC"] = dict(params=(_np(st.actor_params), _np(st.critic_params),
                                   _np(st.target_critic_params), np.asarray(st.log_alpha)),
                           batch=batch, noise=[np.stack([n[i] for n in noise]) for i in (0, 1)])

        jalgo = jddpg.DDPG(OBS, A, DDPG_CFG, pmean_axis="env")
        st = jalgo.init(jax.random.PRNGKey(1))
        fields = ("actor_params", "critic_params", "target_actor_params", "target_critic_params")
        st = st.replace(**{f: _jitter(getattr(st, f), rng, 0.05) for f in fields})
        batch = _batches(rng, rng.uniform(-1, 1, (2, N, A)).astype(np.float32))
        want["DDPG"] = _shard_update(jalgo, False)(st, flat(batch))
        jobs["DDPG"] = dict(params=tuple(_np(getattr(st, f)) for f in fields), batch=batch)

        for name, make in (("DQN", lambda c: jdqn.DQN(OBS, 6, c, pmean_axis="env")),
                           ("BDQ", lambda c: jbdq.BDQ(OBS, 3, c, pmean_axis="env"))):
            jalgo = make(_q_cfg(name))
            st = jalgo.init(jax.random.PRNGKey(2))
            st = st.replace(target_params=_jitter(st.params, rng, 0.05))
            n_act, act_shape = Q_BLOCKS[name][1:]
            batch = _batches(rng, rng.integers(0, n_act, (2, N) + act_shape).astype(np.int32))
            want[name] = _shard_update(jalgo, False)(st, flat(batch))
            jobs[name] = dict(params=(_np(st.params), _np(st.target_params)), batch=batch)

    cfg = cfg_util.load_config(SHARDED)
    cfg["curriculum"].update(window_size=8, n_steps=4, success_threshold=0.5)
    done = np.stack([rng.random((40, 16)) < np.where(np.arange(40) % 5 == 0, 0.6, 0.15)[:, None]
                     for _ in range(2)])
    succ = rng.random((2, 40, 16)) < 0.8
    jobs["curriculum"] = dict(config=cfg, done=done, succ=succ)
    jobs["collectives"] = {}
    jspec = jcurr.CurriculumSpec.from_config(cfg)
    update = jax.jit(lambda s, d, k: jcurr.update(jspec, s, d, k))
    js, jsteps = jcurr.CurriculumState.init(jspec), []
    for i in range(40):
        js = update(js, jnp.asarray(np.concatenate(done[:, i])),
                    jnp.asarray(np.concatenate(succ[:, i])))
        jsteps.append({f: np.asarray(getattr(js, f)) for f in CURR_FIELDS})
    want["curriculum"] = jsteps

    ranks = train_dp.start(_update_worker, 2, "gloo", CPUS, jobs).join(JOIN_TIMEOUT)
    return jobs, want, ranks


def _jax_state_dict(name, new, jobs):
    """The JAX learner's new parameters in the port's state_dict layout."""
    tmpl = _port_learner(name, jobs[name])
    if name == "SAC":
        sd = {"actor": policy_io.actor_state_dict(_np(new.actor_params), tmpl.actor),
              "critic": policy_io.critic_state_dict(_np(new.critic_params), tmpl.critic),
              "target_critic": policy_io.critic_state_dict(_np(new.target_critic_params),
                                                           tmpl.critic)}
        return _leaves(sd), {"/log_alpha": torch.as_tensor(np.asarray(new.log_alpha))}
    if name == "DDPG":
        nets = (("actor", "actor_params"), ("critic", "critic_params"),
                ("target_actor", "target_actor_params"), ("target_critic", "target_critic_params"))
        for net, field in nets:
            policy_io.load_flax_params(getattr(tmpl, net), _np(getattr(new, field)))
        return _leaves({net: getattr(tmpl, net).state_dict() for net, _ in nets}), {}
    sd = {"net": policy_io.q_state_dict(_np(new.params), tmpl.net),
          "target_net": policy_io.q_state_dict(_np(new.target_params), tmpl.net)}
    return _leaves(sd), {}


LR = {"SAC": 3e-4, "DQN": 1e-3, "BDQ": 1e-3, "DDPG": 2e-3}


@pytest.mark.parametrize("name", ["SAC", "DQN", "BDQ", "DDPG"])
def test_sharded_update_matches_jax(parity, name):
    jobs, want, ranks = parity
    r0, r1 = ranks[0][name], ranks[1][name]
    assert set(r0) == set(r1)
    for k in r0:
        assert torch.equal(r0[k], r1[k]), k  # the learner stays replicated
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnet, "CDTYPE", torch.float32)
        params, exact = _jax_state_dict(name, want[name], jobs)
        before = _port_learner(name, jobs[name]).state_dict()
    lr = LR[name]
    online = [k for k in params if "target" not in k]
    diffs = np.concatenate([(r0[k] - params[k]).abs().reshape(-1).numpy() for k in online])
    assert diffs.max() <= 2 * lr + 1e-6 and (diffs > 1e-6).mean() <= 5e-3
    for k in params:
        if "target" in k:
            np.testing.assert_allclose(r0[k].numpy(), params[k].numpy(), atol=1e-6, err_msg=k)
    for k, v in exact.items():
        np.testing.assert_allclose(float(r0[k]), float(v), atol=1e-7)
    # the update moved the parameters
    old = _leaves(before)
    moved = np.concatenate([(r0[k] - old[k]).abs().reshape(-1).numpy() for k in online])
    assert (moved > 0.5 * lr).mean() > 0.5


def test_collectives_give_the_mean_and_the_rank_order(parity):
    """The mean is the sum over ranks divided by the world size (an Adam
    step would not tell a sum from a mean), the gather keeps rank order,
    and every rank gets the same answers."""
    for r in parity[2]:
        c = r["collectives"]
        assert torch.equal(c["mean"][0], torch.full((3,), 1.5))
        assert torch.equal(c["mean"][1], torch.arange(4.0).reshape(2, 2) * 1.5)
        assert torch.equal(c["sum"], torch.tensor([3.0]))
        assert torch.equal(c["gather"], torch.tensor([[0.0, 10.0], [1.0, 11.0]]))
        assert c["any_one"] is True and c["any_none"] is False
        assert torch.equal(c["broadcast"], torch.zeros(2))
    torch.manual_seed(0)
    _assert_same(parity[2][1]["collectives"]["learner"], DDPG(OBS, A, DDPG_CFG).state_dict())


def test_curriculum_over_gathered_masks_matches_jax(parity):
    jobs, want, ranks = parity
    advanced = 0
    for i, ref in enumerate(want["curriculum"]):
        for f in CURR_FIELDS:
            a, b = ranks[0]["curriculum"][i][f], ranks[1]["curriculum"][i][f]
            assert torch.equal(a, b), (i, f)
            np.testing.assert_array_equal(a.numpy(), ref[f], err_msg=f"{i} {f}")
        advanced = int(ref["policy_iteration"]) - 1
    over = (jobs["curriculum"]["done"].sum(axis=(0, 2)) > 8).sum()
    assert advanced >= 2 and over >= 4  # lambda advanced; steps overflowed the window


# ---------------------------------------------------------------- (c), (d)

def _tiny_config(path, window=4, threshold=-1.0, **sac):
    cfg = cfg_util.load_config(SHARDED)
    cfg["tpu"].update(num_envs=4, max_objects=3, move_substeps=2, gripper_substeps=2,
                      solver_iterations=1, pad_inner_iterations=1, updates_per_step=2,
                      demo_frames=16, demo_capacity=16, eval_freq=10 ** 9, checkpoint_freq=8,
                      chunk_steps=2)
    cfg["SAC"].update(batch_size=8, buffer_size=64, learning_starts=8, layers=[16, 16], **sac)
    cfg["curriculum"].update(window_size=window, success_threshold=threshold)
    cfg["time_horizon"] = 3
    io_utils.save_yaml(cfg, path)
    return cfg


def test_world_one_equals_the_plain_trainer(tmp_path):
    cfg = _tiny_config(str(tmp_path / "tiny.yaml"))
    runs = []
    with train_dp.process_group("gloo", 1, 0, str(tmp_path)):
        dp = train_dp.DataParallel("cpu")
        for make in (lambda: Trainer(cfg, "SAC", "cpu", seed=5),
                     lambda: train_dp.make_sharded_trainer(cfg, dp, "SAC", seed=5)):
            torch.manual_seed(0)  # the learner's initial weights
            t = make()
            s = t.init_state()
            s, n_done, _ = t.seed_demos(s, 16)
            s, metrics = t.train_chunk(s, 2)
            runs.append((t, s, metrics, n_done))
    (pt, ps, pm, pd), (st, ss, sm, sd) = runs
    assert st.total_envs == st.num_envs == pt.num_envs == 4 and st.dp.world == 1
    assert pt.algo.step == st.algo.step == 4 and pd == sd
    _assert_same(pt.algo.state_dict(), st.algo.state_dict())
    for f in CURR_FIELDS:
        assert torch.equal(getattr(ps.curriculum, f), getattr(ss.curriculum, f)), f
    for f in ("obs", "action", "reward", "done"):
        assert torch.equal(getattr(ps.buffer, f), getattr(ss.buffer, f)), f
    assert set(pm) == set(sm) and all(torch.equal(pm[k], sm[k]) for k in pm)
    for g in ("env_gen", "learn_gen", "demo_gen"):
        assert torch.equal(getattr(pt, g).get_state(), getattr(st, g).get_state()), g


def _argv(cfg_path, model_dir, *extra):
    return ["train", "--config", cfg_path, "--algo", "SAC", "--model_dir", model_dir,
            "--device", "cpu", "--seed", "2", *extra]


def _rows(path):
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if ln and not ln.startswith("#")]


@pytest.fixture(scope="module")
def w2_run(tmp_path_factory):
    """A world-2 run with no end in sight, stopped by a SIGTERM to rank 1
    after rank 0 logged two chunks. Its curriculum window never fills or
    advances, so it counts every episode it folds."""
    root = tmp_path_factory.mktemp("w2")
    cfg_path, model_dir = str(root / "tiny.yaml"), str(root / "run")
    cfg = _tiny_config(cfg_path, window=10_000, threshold=1.0, total_timesteps=10 ** 6)
    ranks = train_dp.start(train_dp.rank_main, 2, "gloo", CPUS, _argv(cfg_path, model_dir))
    logs, deadline = os.path.join(model_dir, "logs.csv"), time.monotonic() + JOIN_TIMEOUT
    while not (os.path.exists(logs) and len(_rows(logs)) >= 3):
        assert time.monotonic() < deadline, "the world-2 run logged no two chunks in time"
        time.sleep(0.2)
    os.kill(ranks.pids[1], signal.SIGTERM)
    t0 = time.monotonic()
    results = ranks.join(JOIN_TIMEOUT)
    return cfg, cfg_path, model_dir, results, time.monotonic() - t0


def test_sigterm_to_one_rank_stops_both(w2_run):
    cfg, _, model_dir, (r0, r1), stop_seconds = w2_run
    assert stop_seconds < 60
    assert r0["step"] == r1["step"] > 0
    for r in (r0, r1):
        assert not r["result"]["done"] and r["result"]["frames"] == 2 * r["step"]
    frames = r0["result"]["frames"]
    assert frames % 8 == 0 and frames >= 16  # whole chunks: 2 steps x 2 envs x 2 ranks
    assert cb.Checkpointer(model_dir).latest_step() == frames
    with open(os.path.join(model_dir, "runs.jsonl")) as f:
        rec = json.loads(f.read().splitlines()[-1])
    assert (rec["world"], rec["backend"], rec["frames"], rec["done"]) == (2, "gloo", frames, False)


def test_world_two_ranks_share_the_learner_and_curriculum(w2_run):
    _, _, _, (r0, r1), _ = w2_run
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    assert r0["result"]["updates"] == r1["result"]["updates"] > 0
    _assert_same(r0["learner"], r1["learner"])  # every leaf, not the first only
    _assert_same(r0["curriculum"], r1["curriculum"])
    # both ranks folded both ranks' episodes
    assert int(r0["curriculum"]["filled"]) == r0["result"]["episodes"] > 0
    assert not torch.equal(r0["env_states"]["objects.pos"], r1["env_states"]["objects.pos"])
    for k in ("env", "learn", "demo"):
        assert not torch.equal(r0["generators"][k], r1["generators"][k]), k


def test_world_two_splits_demos_and_counts_frames(w2_run):
    cfg, _, model_dir, (r0, r1), _ = w2_run
    per_rank = cfg["tpu"]["num_envs"] // 2
    assert r0["num_envs"] == r1["num_envs"] == per_rank
    demo_rows = cfg["tpu"]["demo_frames"] // 2  # each rank seeds half
    for r in (r0, r1):
        assert r["result"]["replay_rows"] == demo_rows + r["step"]
        assert r["result"]["demo"] == r0["result"]["demo"]
    local = np.array([r0["demo_local"], r1["demo_local"]])
    assert r0["result"]["demo"] == dict(episodes=local[:, 0].sum(), successes=local[:, 1].sum())
    assert local[:, 0].min() > 0
    # the monitor holds every rank's episodes
    monitor = _rows(os.path.join(model_dir, "log_file.monitor.csv"))
    assert len(monitor) - 1 == r0["result"]["episodes"] > 0


def test_checkpoints_resume_across_world_sizes(w2_run, tmp_path):
    cfg, cfg_path, model_dir, (r0, _), _ = w2_run
    frames = r0["result"]["frames"]
    one = str(tmp_path / "w1")
    (w1,) = train_dp.launch_train(_argv(cfg_path, one, "--load_dir", model_dir,
                                        "--timestep", str(frames + 8)), 1, "gloo", ["cpu"])
    res = w1["result"]
    assert (res["resume_frames"], res["frames"], w1["step"], res["done"]) == (
        frames, frames + 8, frames + 8, True)
    assert res["updates"] == r0["result"]["updates"] + 2 * cfg["tpu"]["updates_per_step"]
    _assert_same(w1["curriculum"]["lam"], r0["curriculum"]["lam"])
    two = train_dp.launch_train(_argv(cfg_path, str(tmp_path / "w2"), "--load_dir", one,
                                      "--timestep", str(frames + 16)), 2, "gloo", CPUS,
                                timeout=JOIN_TIMEOUT)
    for r in two:
        assert (r["result"]["resume_frames"], r["result"]["frames"], r["step"]) == (
            frames + 8, frames + 16, (frames + 16) // 2)
        assert r["result"]["updates"] == res["updates"] + 2 * cfg["tpu"]["updates_per_step"]
    _assert_same(two[0]["learner"], two[1]["learner"])


def test_world_two_keeps_the_normalizer_per_rank(w2_run):
    # the reference behaviour reproduced: each rank folds its own envs'
    # observations, and the checkpoint carries rank 0's moments
    _, _, model_dir, (r0, r1), _ = w2_run
    bundle = cb.Checkpointer(model_dir).restore(device="cpu")
    for f in ("mean", "var", "count"):
        assert torch.equal(bundle["obs_rms"][f], r0["obs_rms"][f]), f
    assert not torch.equal(r0["obs_rms"]["mean"], r1["obs_rms"]["mean"])


def test_merged_moments_are_the_moments_of_both_ranks():
    x = torch.from_numpy(np.random.default_rng(3).normal(1.0, 2.0, (40, 6)))

    def moments(b):
        return RunningMeanStd(mean=b.mean(0), var=b.var(0, unbiased=False),
                              count=torch.tensor(float(len(b)), dtype=b.dtype))

    merged, whole = normalizer_probe.merge_rms(moments(x[:15]), moments(x[15:])), moments(x)
    for f in ("mean", "var", "count"):
        torch.testing.assert_close(getattr(merged, f), getattr(whole, f), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- (e)

def test_jax_reference_learners_differ_across_devices():
    """The JAX data-parallel trainer gives each device the learner of its
    own key, so its replicas are apart before the first update (ROADMAP
    Queue 3); the port broadcasts rank 0's learner instead (test (d))."""
    jalgo = jsac.SAC(OBS, A, SAC_CFG)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)  # train.py:121-122
    states = [jalgo.init(jax.random.split(k, 3)[1]) for k in keys]  # init_state's k_algo
    for field in ("actor_params", "critic_params", "target_critic_params"):
        a, b = (_leaves(_np(getattr(s, field))) for s in states)
        kernels = [k for k in a if k.endswith("kernel")]
        assert kernels and all(np.abs(a[k] - b[k]).max() > 1e-2 for k in kernels), field
        assert all(np.array_equal(a[k], b[k]) for k in a if k.endswith("bias")), field
