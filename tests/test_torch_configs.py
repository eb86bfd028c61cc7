"""Every shipped config either builds a trainer of the port or is refused by
name, on the CPU at a tiny width (port only: no JAX).

For each `configs/*.yaml` and each algorithm block it holds (SAC, DQN, BDQ,
DDPG, PPO, TRPO; the reference-style configs hold several), the config is
cut to 2 envs, 8 hidden units per layer and a 64-row replay, the algorithm
is set as `train` sets it (`robot.discrete` for DQN and BDQ), and
`train.make_trainer` builds the replay trainer or the on-policy trainer and
its learner; the trainer's observation shape is the one `run` builds a
policy for (`grasp_env.observation_shape`). Table clearing
(`sac_table_clearing.yaml`) builds its OnTable tray env; the folded update
(`sac_simplified_batched_quality.yaml`, `tpu.update_batch_scale` 8) builds
with the batch and the update count folded; the data-parallel quality
config (`sac_simplified_sharded_quality.yaml`, `tpu.sharded`) builds the
trainer each of its ranks runs. Two configs are refused, each with the
error that names what the port does not have: encoder latents with no
trained encoder (`sac_simplified_sharded.yaml` and
`sac_simplified_demo.yaml` name no `sensor.encoder_dir`; a deliberate
difference, where the JAX package runs a downsampled-depth stand-in). PPO
and TRPO with `tpu.sharded` are refused by name, by `make_trainer` and by
`train` (the data-parallel trainer shards the replay learners only; the
JAX package quietly trains such a config on one device). The two camera files are not training
configs: every other config names them as its sensor files. The loop
state is not built: resetting full-physics envs on the CPU takes seconds
per config, and tests/test_torch_training.py and the algorithm tests build
it for the shipped families.
"""

import glob
import os

import pytest
import torch

from deep_rl_grasping_tpu_torch.envs.grasp_env import observation_shape
from deep_rl_grasping_tpu_torch.training import train
from deep_rl_grasping_tpu_torch.training.trainer import ALGOS
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
CAMERA_FILES = {"camera_info.yaml": "camera_info", "camera_transform.yaml": "transform"}
REFUSED = {"sac_simplified_sharded.yaml": (ValueError, "need sensor.encoder_dir"),
           "sac_simplified_demo.yaml": (ValueError, "need sensor.encoder_dir")}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _narrow(layers):
    return [_narrow(x) for x in layers] if isinstance(layers, list) else 8


def _tiny(config, algo):
    cfg = cfg_util.load_config(config)
    cfg["tpu"].update(num_envs=2)
    if cfg["tpu"].get("demo_frames"):
        cfg["tpu"]["demo_capacity"] = 64
    block = cfg.setdefault(algo, {})
    block["buffer_size"] = 64
    if "layers" in block:
        block["layers"] = _narrow(block["layers"])
    cfg["robot"]["discrete"] = algo in ("DQN", "BDQ")
    cfg["algorithm"] = algo.lower()
    return cfg


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_builds_a_trainer_or_is_refused(path):
    name = os.path.basename(path)
    raw = io_utils.load_yaml(path)
    if name in CAMERA_FILES:
        assert not set(raw) & set(ALGOS) and "tpu" not in raw
        named = [io_utils.load_yaml(p)["sensor"][CAMERA_FILES[name]] for p in CONFIGS
                 if os.path.basename(p) not in CAMERA_FILES]
        assert set(named) == {f"configs/{name}"}
        return
    algos = [a for a in ALGOS if a in raw]
    assert algos, f"{name} holds no algorithm block"
    for algo in algos:
        cfg = _tiny(path, algo)
        if name in REFUSED:
            err, match = REFUSED[name]
            with pytest.raises(err, match=match):
                train.make_trainer(cfg, algo, "cpu")
            continue
        trainer = train.make_trainer(cfg, algo, "cpu")
        assert trainer.algo_name == algo and trainer.num_envs == 2
        assert tuple(trainer.env.obs_shape) == tuple(observation_shape(cfg))
        assert trainer.algo.step == 0 and trainer.algo.gamma == cfg["discount_factor"]
        if algo in ("PPO", "TRPO"):
            assert trainer.frames_per_iteration == 2 * trainer.algo.n_steps
        else:
            assert trainer.buffer_size == 64
            scale = int(cfg["tpu"].get("update_batch_scale", 1) or 1)
            assert trainer.updates_per_step * scale == int(cfg["tpu"].get("updates_per_step", 1))
            assert trainer.batch_size == scale * int(cfg[algo].get("batch_size", 256))
        if name == "sac_simplified_batched_quality.yaml":
            assert (trainer.updates_per_step, trainer.batch_size) == (4, 1024)
            assert trainer.algo.batch_size == 1024
            assert trainer.algo.bc_tail == 256  # demo_fraction 0.25 of the folded batch
        if name == "sac_table_clearing.yaml":
            env = trainer.env
            assert env.reward_spec.table_clearing and env.sim_params.has_tray
            assert env.max_slots == 5 and env.time_horizon == 200
        if name == "sac_simplified_sharded_quality.yaml":
            assert cfg["tpu"]["sharded"] and trainer.algo.batch_size == 128


@pytest.mark.parametrize("name", ["ppo_simplified.yaml", "trpo_simplified.yaml"])
def test_on_policy_sharded_is_refused(name, tmp_path):
    algo = name.split("_")[0].upper()
    cfg = _tiny(os.path.join(REPO, "configs", name), algo)
    cfg["tpu"]["sharded"] = True
    with pytest.raises(ValueError, match=f"{algo}: the data-parallel trainer shards the replay"):
        train.make_trainer(cfg, algo, "cpu")
    path, run = str(tmp_path / "sharded.yaml"), str(tmp_path / "run")
    io_utils.save_yaml(cfg, path)
    with pytest.raises(ValueError, match="replay learners only"):
        train.main(["train", "--config", path, "--algo", algo, "--model_dir", run,
                    "--device", "cpu"])
    assert not os.path.exists(run)
