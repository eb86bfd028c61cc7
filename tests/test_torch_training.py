"""The port's `train` entry point, end to end on the CPU at a tiny size.

`train.main(["train", ...])` on the RGB-D, the depth and the encoder-latent
flagship config, each cut to 2 envs, a
3-step horizon, 16/16 hidden units, a 64-frame replay, 2 updates per
iteration and 6 chunks of 2 iterations, with demo seeding and refresh, the
eval cadence and checkpoints all firing, and a curriculum window of 2
episodes that advances lambda. It must write config.yaml (readable back
by the port's reader and PyYAML into the same tree), the monitor, scalar,
eval and curriculum CSVs and a TensorBoard file; every logged loss must be
finite; `run --model` must read the latest and the best checkpoint back.
Also: the checkpointer's keep-3 / best-1 files, and `save_yaml` round trips
every config the repo ships.
"""

import csv
import glob
import os

import numpy as np
import pytest
import torch
import yaml

from deep_rl_grasping_tpu_torch.training import callbacks as cb
from deep_rl_grasping_tpu_torch.training import train
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils, tb_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=["sac_rgbd_flagship.yaml", "sac_full_flagship.yaml",
                                        "sac_encoder_flagship.yaml"])
def tiny_run(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    cfg = cfg_util.load_config(os.path.join(REPO, "configs", request.param))
    cfg["tpu"].update(num_envs=2, max_objects=3, gripper_substeps=2, solver_iterations=1,
                      pad_inner_iterations=1, updates_per_step=2, demo_frames=8,
                      demo_capacity=16, demo_refresh_every=8, demo_refresh_frames=4,
                      eval_freq=8, checkpoint_freq=4, chunk_steps=2, recent_window=8)
    cfg["SAC"].update(batch_size=8, buffer_size=64, learning_starts=8, total_timesteps=24,
                      layers=[16, 16])
    cfg["curriculum"].update(window_size=2, success_threshold=-1.0)
    cfg["time_horizon"] = 3
    path = str(root / "tiny.yaml")
    io_utils.save_yaml(cfg, path)
    model_dir = str(root / "run")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = train.main(["train", "--config", path, "--algo", "SAC", "--model_dir", model_dir,
                          "--device", "cpu", "--seed", "3"])
        ev = train.main(["run", "--model", model_dir, "--episodes", "2", "--device", "cpu"])
        ev_best = train.main(["run", "--model", model_dir, "-b", "--episodes", "2",
                              "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    return cfg, model_dir, res, ev, ev_best, request.param


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_train_writes_config_logs_and_checkpoints(tiny_run):
    cfg, model_dir, res, *_ = tiny_run
    assert res["done"] and res["frames"] == 24
    for sub in ("config.yaml", os.path.join("best_model", "config.yaml")):
        written = io_utils.load_yaml(os.path.join(model_dir, sub))
        with open(os.path.join(model_dir, sub)) as f:
            assert yaml.safe_load(f) == written
        assert written["algorithm"] == "sac" and written["tpu"] == cfg["tpu"]
    with open(os.path.join(model_dir, "log_file.monitor.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("#") and lines[1] == "r,l,t,s"
    episodes = [ln.split(",") for ln in lines[2:]]
    # 12 iterations of 2 envs with a 3-step horizon; demo steps in between end
    # episodes too, but those are not monitored
    assert len(episodes) == res["episodes"] >= 4
    assert all(int(float(e[1])) == 3 for e in episodes)
    rows = _rows(os.path.join(model_dir, "logs.csv"))
    assert [int(r["step"]) for r in rows] == [4, 8, 12, 16, 20, 24]
    for r in rows:
        for k in ("critic_loss", "actor_loss", "bc_loss", "alpha_loss", "q_target_mean"):
            assert np.isfinite(float(r[k])), (k, r[k])
    assert res["updates"] == 2 * 12
    ev = _rows(os.path.join(model_dir, "eval_logs.csv"))
    assert [int(r["step"]) for r in ev] == [8, 16, 24]
    with open(os.path.join(model_dir, "curriculum_steps.csv")) as f:
        curr = [ln.split() for ln in f.read().splitlines()]
    assert len(curr) >= 2 and float(curr[-1][1]) == res["curriculum_lambda"] > 0.0
    events = glob.glob(os.path.join(model_dir, "tb", "events.out.tfevents.*"))
    assert len(events) == 1
    tags = {tag for _step, _t, scalars in tb_events.read_events(events[0]) for tag in scalars}
    assert {"critic_loss", "curriculum_lambda", "eval_success_rate"} <= tags
    assert sorted(os.listdir(os.path.join(model_dir, "logs"))) == [
        "ckpt_16.pt", "ckpt_20.pt", "ckpt_24.pt"]
    assert len(glob.glob(os.path.join(model_dir, "best_model", "ckpt_*.pt"))) == 1


def test_run_model_reads_the_checkpoints_back(tiny_run):
    _, model_dir, res, ev, ev_best, cfg_path = tiny_run
    for r in (ev, ev_best):
        assert r["episodes"] == 2 and r["mean_length"] == 3.0
        assert np.isfinite(r["mean_return"])
    bundle = cb.Checkpointer(model_dir).restore()
    assert bundle["algo_state"]["step"] == res["updates"]
    assert set(bundle) == {"algo_state", "obs_rms", "ret_rms", "curriculum"}
    shape = {"sac_rgbd_flagship.yaml": (64, 64, 5), "sac_full_flagship.yaml": (64, 64, 2),
             "sac_encoder_flagship.yaml": (101,)}[os.path.basename(cfg_path)]
    assert bundle["obs_rms"]["mean"].shape == shape
    assert float(bundle["curriculum"]["lam"]) == res["curriculum_lambda"]


def test_checkpointer_keeps_three_and_the_best(tmp_path):
    ck = cb.Checkpointer(str(tmp_path))
    for step in (1, 2, 3, 4, 5):
        ck.save(step, {"x": torch.tensor(float(step))})
    assert ck.latest_step() == 5
    assert sorted(os.listdir(tmp_path / "logs")) == ["ckpt_3.pt", "ckpt_4.pt", "ckpt_5.pt"]
    assert float(ck.restore()["x"]) == 5.0 and float(ck.restore(4)["x"]) == 4.0
    assert ck.save_best(1, {"x": torch.tensor(1.0)}, -3.0)
    assert not ck.save_best(2, {"x": torch.tensor(2.0)}, -4.0)
    assert ck.save_best(3, {"x": torch.tensor(3.0)}, 7.0)
    assert float(ck.restore_best()["x"]) == 3.0
    assert os.listdir(tmp_path / "best_model") == ["ckpt_3.pt"]
    with pytest.raises(FileNotFoundError):
        cb.Checkpointer(str(tmp_path / "empty")).restore()


CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.basename(p))
def test_save_yaml_round_trips(path, tmp_path):
    cfg = cfg_util.load_config(path)
    out = str(tmp_path / "c.yaml")
    io_utils.save_yaml(cfg, out)
    assert io_utils.load_yaml(out) == cfg
    with open(out) as f:
        assert yaml.safe_load(f) == cfg


def test_train_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit):
        train.main(["train", "--config", os.path.join(REPO, "configs", "sac_rgbd_flagship.yaml"),
                    "--algo", "SAC", "--model_dir", str(tmp_path)])


def _flagship_config(**tpu):
    cfg = cfg_util.load_config(os.path.join(REPO, "configs", "sac_rgbd_flagship.yaml"))
    cfg["tpu"].update(tpu)
    return cfg


@pytest.mark.parametrize("tpu,algo,item",
                         [(dict(sharded=True), "PPO", "replay learners only"),
                          (dict(update_batch_scale=3), "SAC", "must divide")],
                         ids=["sharded", "update_batch_scale"])
def test_trainer_refuses_what_the_port_cannot_honour(tpu, algo, item):
    """A config the port would otherwise run differently from what it asks
    is refused: `tpu.sharded` with an on-policy learner (the data-parallel
    trainer shards the replay learners; the JAX package would train it on
    one device), and an update batch scale that does not divide the
    updates per step (128), as the JAX trainer refuses it
    (trainer.py:252-255)."""
    with pytest.raises(ValueError, match=item):
        train.make_trainer(_flagship_config(**tpu), algo, "cpu")


def test_trainer_builds_the_flagship_config():
    """The shipped flagship config (sharded false, no batch scale) still
    builds, at full width; and it turns replay-ring snapshots on with the
    JAX trainer's defaults (the newest 65536 rows every 500,000 frames),
    unless the config sets the rows to 0."""
    from deep_rl_grasping_tpu_torch.training.trainer import Trainer

    cfg = _flagship_config(update_batch_scale=1, sharded=False)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.num_envs == 128 and trainer.updates_per_step == 128
    assert trainer.batch_size == 256
    assert train.ring_settings(cfg["tpu"]) == (65536, 500_000)
    assert train.ring_settings(dict(cfg["tpu"], ring_checkpoint_rows=0))[0] == 0
