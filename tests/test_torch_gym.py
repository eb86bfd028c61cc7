"""The port's gym-side periphery vs the JAX package, on the CPU.

* `envs/gym_adapter.py` `GymGraspEnv`: spaces, `reset` (its shape), and two `step`s
  from one JAX-built state carried across, the second of which ends the
  episode at its time limit; rewards to 1e-2 and returns to 2e-2 (as
  tests/test_torch_env.py holds the batched step), dones, statuses and
  the curriculum window exactly, and the observation to 1e-4 on all but
  0.1% of its values against the JAX package's Pallas render (interpret
  mode) of its stepped state, the raster the port replaces. The gripper
  helpers (`get_pose`, `get_gripper_width`, `object_detected`,
  `num_alive_objects`, `close_gripper`, `open_gripper`) agree to 1e-5 on
  the same states. The small flagship depth config of tests/test_torch_env.py.
* `envs/wrappers.py` `TimeFeatureGymWrapper` against the JAX wrapper on
  the same observations, in both modes, and around the port's adapter.
* `agents/agents.py`: the random, constant and scripted agents' actions
  equal the JAX copies' under the same numpy generator.
* `tools/debug_scene.py` on the CPU writes one PNG per step: the RGB,
  depth and segmentation of the raster's plain version side by side.
* `scripts/plot.py` (which imports nothing of either package) reads the
  monitor and scalar CSVs of a tiny run of the port's `train` on the
  sharded quality config (one gloo rank on the CPU).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu.agents import agents as jagents
from deep_rl_grasping_tpu.envs import gym_adapter as jgym
from deep_rl_grasping_tpu.envs import wrappers as jwrappers
from deep_rl_grasping_tpu_torch.agents import agents as tagents
from deep_rl_grasping_tpu_torch.envs import gym_adapter as tgym
from deep_rl_grasping_tpu_torch.envs import wrappers as twrappers
from deep_rl_grasping_tpu_torch.tools import debug_scene
from deep_rl_grasping_tpu_torch.training import train
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils
from tests.test_torch_env import _jax_state_to_torch, _pallas_obs, small_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- adapter

@pytest.fixture(scope="module")
def adapters():
    """Both adapters on one JAX-built reset state, one step before its time
    limit; then the outputs of two steps and of the helpers in both."""
    cfg = small_config()
    jg = jgym.GymGraspEnv(cfg, evaluate=True, validate=True)
    tg = tgym.GymGraspEnv(cfg, evaluate=True, validate=True, device="cpu")
    je = jg.env
    keys = jax.random.split(jax.random.PRNGKey(6), 1)
    batched = jax.jit(jax.vmap(lambda k: je.reset_env(k, 1.0, settle_substeps=0)))(keys)
    batched = batched.replace(episode_step=jnp.asarray([je.time_horizon - 2], jnp.int32))
    jg._state = jax.tree.map(lambda x: x[0], batched)
    tg._state = _jax_state_to_torch(batched)
    out = {"spaces": (jg, tg)}

    def helpers():
        return dict(pose=(jg.get_pose(), tg.get_pose()),
                    width=(jg.get_gripper_width(), tg.get_gripper_width()),
                    detected=(jg.object_detected(), tg.object_detected()),
                    alive=(jg.num_alive_objects, tg.num_alive_objects))

    rng = np.random.default_rng(8)
    actions = rng.uniform(-1.0, 1.0, (2, 5)).astype(np.float32)
    actions[1, 4] = -1.0  # close on the second step
    steps = []
    for i in range(2):
        jstep, tstep = jg.step(actions[i]), tg.step(actions[i])
        steps.append(dict(j=jstep, t=tstep, jobs=_pallas_obs(je, jax.tree.map(
            lambda x: x[None], jg._state))[0], helpers=helpers(),
            jcur=jg.curriculum, tcur=tg.curriculum))
    out["steps"] = steps
    jg.close_gripper()
    tg.close_gripper()
    out["closed"] = helpers()
    jg.open_gripper()
    tg.open_gripper()
    out["opened"] = helpers()
    out["reset"] = tg.reset()
    return out


def test_spaces_and_reset_match_jax(adapters):
    jg, tg = adapters["spaces"]
    assert tg.action_space == tgym.BoxSpace(-1.0, 1.0, (5,))
    assert (tg.action_space.low, tg.action_space.high, tg.action_space.shape) == (
        jg.action_space.low, jg.action_space.high, jg.action_space.shape)
    assert (tg.observation_space.low, tg.observation_space.high) == (
        jg.observation_space.low, jg.observation_space.high)
    assert tuple(tg.observation_space.shape) == tuple(jg.observation_space.shape) == (64, 64, 2)
    assert tg.is_simplified() == jg.is_simplified() and tg.is_discrete() == jg.is_discrete()
    assert (tg.depth_obs, tg.full_obs) == (jg.depth_obs, jg.full_obs)
    tobs = adapters["reset"]
    assert tobs.shape == jg.observation_space.shape and tobs.dtype == np.float32
    assert np.isfinite(tobs).all() and tobs[..., 0].std() > 0
    discrete = tgym.DiscreteSpace(12)
    assert discrete.shape == () and 0 <= discrete.sample(np.random.default_rng(0)) < 12


@pytest.mark.parametrize("i", [0, 1])
def test_step_matches_jax(adapters, i):
    s = adapters["steps"][i]
    (jo, jr, jd, ji), (to, tr, td, ti) = s["j"], s["t"]
    assert td == jd == (i == 1)  # the second step reaches the time limit
    np.testing.assert_allclose(tr, jr, atol=1e-2, rtol=0)
    assert set(ti) == set(ji)
    for k in ("is_success", "episode_step", "status", "objects_alive"):
        np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    np.testing.assert_allclose(ti["episode_return"], ji["episode_return"], atol=2e-2)
    for f in ("lam", "ring", "ptr", "filled", "sr_mean", "policy_iteration"):
        np.testing.assert_array_equal(getattr(s["tcur"], f).numpy(),
                                      np.asarray(getattr(s["jcur"], f)), err_msg=f)
    assert int(s["tcur"].filled) == i
    assert to.shape == jo.shape == (64, 64, 2)
    if i == 0:  # after the time limit each package starts a scene of its own
        off = np.abs(to - s["jobs"]) > 1e-4
        assert off.mean() <= 1e-3


@pytest.mark.parametrize("when", ["step0", "step1", "closed", "opened"])
def test_gripper_helpers_match_jax(adapters, when):
    h = adapters["steps"][int(when[-1])]["helpers"] if when.startswith("step") else adapters[when]
    (jpos, jquat), (tpos, tquat) = h["pose"]
    np.testing.assert_allclose(tpos, np.asarray(jpos), atol=1e-5)
    np.testing.assert_allclose(tquat, np.asarray(jquat), atol=1e-5)
    assert abs(np.linalg.norm(tquat) - 1.0) < 1e-5
    np.testing.assert_allclose(h["width"][1], h["width"][0], atol=1e-5)
    assert h["detected"][1] == h["detected"][0] and h["alive"][1] == h["alive"][0] > 0


def test_close_and_open_move_the_fingers(adapters):
    opened, closed = adapters["opened"]["width"][1], adapters["closed"]["width"][1]
    assert closed < opened - 1e-3


# ---------------------------------------------------------------- wrapper

class _StubEnv:
    """Numpy observations of a fixed shape and a time horizon."""

    def __init__(self, space_cls, shape=(3, 2), horizon=4):
        self.env = type("E", (), {"time_horizon": horizon})()
        self.observation_space = space_cls(-2.0, 2.0, shape)
        self.action_space = space_cls(-1.0, 1.0, (5,))
        self._rng = np.random.default_rng(4)
        self.extra = "passed through"

    def reset(self):
        return self._rng.normal(size=self.observation_space.shape).astype(np.float32)

    def step(self, action):
        return self.reset(), 1.0, False, {"k": 1}


@pytest.mark.parametrize("test_mode", [False, True])
def test_time_feature_wrapper_matches_jax(test_mode):
    tw = twrappers.TimeFeatureGymWrapper(_StubEnv(tgym.BoxSpace), test_mode=test_mode)
    jw = jwrappers.TimeFeatureGymWrapper(_StubEnv(jgym.BoxSpace), test_mode=test_mode)
    assert (tw.observation_space.low, tw.observation_space.high, tw.observation_space.shape) == (
        jw.observation_space.low, jw.observation_space.high, jw.observation_space.shape) == (
        -2.0, 1.0, (7,))
    got, want = [tw.reset()], [jw.reset()]
    for _ in range(5):
        got.append(tw.step(np.zeros(5))[0])
        want.append(jw.step(np.zeros(5))[0])
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert got[2][-1] == (1.0 if test_mode else 0.5) and tw.extra == "passed through"


def test_time_feature_wrapper_around_the_adapter():
    cfg = small_config()
    env = twrappers.TimeFeatureGymWrapper(tgym.GymGraspEnv(cfg, device="cpu"))
    obs = env.reset()
    assert obs.shape == (64 * 64 * 2 + 1,) and obs[-1] == 1.0
    obs, _, _, _ = env.step(np.zeros(5, np.float32))
    assert obs[-1] == pytest.approx(1.0 - 1.0 / cfg["time_horizon"])
    assert env.is_simplified() is False


# ---------------------------------------------------------------- agents

class _PoseEnv:
    """A gripper that descends 1 cm per call, then climbs."""

    def __init__(self, space):
        self.action_space = space
        self.z = 0.2

    def get_pose(self):
        self.z -= 0.01
        return np.array([0.0, 0.0, self.z], np.float32), np.array([1.0, 0, 0, 0], np.float32)


@pytest.mark.parametrize("space", ["box", "discrete"])
def test_random_and_constant_agents_match_jax(space):
    make = {"box": lambda m: m.BoxSpace(-1.0, 1.0, (5,)), "discrete": lambda m: m.DiscreteSpace(12)}
    ta = tagents.RandomAgent(_PoseEnv(make[space](tgym)), np.random.default_rng(3))
    ja = jagents.RandomAgent(_PoseEnv(make[space](jgym)), np.random.default_rng(3))
    for _ in range(20):
        np.testing.assert_array_equal(ta.act(None), ja.act(None))
    const = np.arange(5, dtype=np.float32)
    np.testing.assert_array_equal(tagents.ConstantAgent(const).act(None),
                                  jagents.ConstantAgent(const).act(None))
    with pytest.raises(NotImplementedError):
        tagents.Agent().act(None)


def test_scripted_agent_matches_jax():
    ta = tagents.ScriptedGraspAgent(_PoseEnv(None), np.random.default_rng(5))
    ja = jagents.ScriptedGraspAgent(_PoseEnv(None), np.random.default_rng(5))
    got = [ta.act(None) for _ in range(40)]
    want = [ja.act(None) for _ in range(40)]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    # descend open, close, lift closed
    assert {(a[2], a[4]) for a in got} == {(0.5, 1.0), (0.0, -1.0), (-1.0, -1.0)}
    ta.reset()
    assert ta._lift_steps == 0


# ---------------------------------------------------------------- tools, plot

def test_debug_scene_writes_its_frames(tmp_path):
    cfg = small_config()
    path = str(tmp_path / "small.yaml")
    io_utils.save_yaml(cfg, path)
    out = str(tmp_path / "frames")
    frames = debug_scene.main(["--config", path, "--agent", "scripted", "--steps", "2",
                               "--out", out, "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["step_000.png", "step_001.png"] and len(frames) == 2
    img = debug_scene.read_png(frames[1])
    s = debug_scene.SCALE
    assert img.shape == (64 * s, 3 * 64 * s, 3) and img.dtype == np.uint8
    rgb, depth, seg = (img[::s, i * 64 * s:(i + 1) * 64 * s:s] for i in range(3))
    assert rgb.std() > 5 and depth.std() > 5 and len(np.unique(seg.reshape(-1, 3), axis=0)) >= 3
    np.testing.assert_array_equal(depth[..., 0], depth[..., 2])  # grey


def test_debug_scene_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="--device cpu"):
        debug_scene.main(["--steps", "1", "--out", str(tmp_path)])


def _plot_module():
    spec = importlib.util.spec_from_file_location("plot", os.path.join(REPO, "scripts", "plot.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plot_reads_a_port_run(tmp_path):
    cfg = cfg_util.load_config(os.path.join(REPO, "configs", "sac_simplified_sharded_quality.yaml"))
    cfg["tpu"].update(num_envs=2, max_objects=3, move_substeps=2, gripper_substeps=2,
                      solver_iterations=1, pad_inner_iterations=1, updates_per_step=1,
                      demo_frames=4, demo_capacity=8, eval_freq=10 ** 9, checkpoint_freq=8,
                      chunk_steps=2)
    cfg["SAC"].update(batch_size=4, buffer_size=32, learning_starts=4, layers=[8, 8],
                      total_timesteps=12)
    cfg["time_horizon"] = 2
    path, run = str(tmp_path / "tiny.yaml"), str(tmp_path / "run")
    io_utils.save_yaml(cfg, path)
    res = train.main(["train", "--config", path, "--algo", "SAC", "--model_dir", run,
                      "--device", "cpu"])
    assert res["world"] == 1 and res["done"] and res["frames"] == 12
    plot = _plot_module()
    monitor = plot.read_monitor(os.path.join(run, "log_file.monitor.csv"))
    assert len(monitor) == res["episodes"] > 0
    assert set(monitor[0]) == {"r", "l", "t", "s"} and all(1 <= r["l"] <= 2 for r in monitor)
    logs = plot.read_logs(os.path.join(run, "logs.csv"))
    assert [r["step"] for r in logs] == [4.0, 8.0, 12.0]
    assert {"success_rate", "curriculum_lambda", "critic_loss"} <= set(logs[0])
