"""Command line entry point of the port (counterpart of
deep_rl_grasping_tpu/training/train.py).

    python -m deep_rl_grasping_tpu_torch.training.train run \
        --npz trained/sac_full_flagship_r5c [--episodes N] [-t] [--stochastic] \
        [--device cuda|cpu]

`run` evaluates a committed SAC policy bundle on the 100-episode protocol
(train.py:474). It runs on the card unless `--device cpu` is given; with
no card and no `--device cpu` it stops with an error instead of falling
back. Training (`train`) waits for a later slice.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from deep_rl_grasping_tpu_torch.envs.actuator import ActuatorSpec
from deep_rl_grasping_tpu_torch.models.networks import SACActor
from deep_rl_grasping_tpu_torch.training.trainer import Evaluator
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils, policy_io


def set_precision():
    """Float32 matmuls and convolutions in full float32 (no TF32) on the
    card; the networks' bf16 layers are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load_bundle_actor(model_dir, device):
    """Build the SAC actor for a bundle's config and load its weights.
    Returns (config, actor, normalizer)."""
    config = cfg_util.load_config(os.path.join(model_dir, "config.yaml"))
    algo = config.get("algorithm", "sac").upper()
    if algo != "SAC":
        raise SystemExit(f"the port evaluates SAC bundles only (bundle algo: {algo})")
    if not config.get("depth_observation") or config.get("full_observation"):
        raise SystemExit("the port evaluates depth-observation bundles only")
    info = io_utils.load_yaml(cfg_util.resolve_path(config["sensor"]["camera_info"]))
    obs_shape = (int(info["height"]), int(info["width"]), 2)
    layers = tuple(config.get("SAC", {}).get("layers", [64, 64]))
    action_dim = ActuatorSpec.from_config(config).action_dim
    actor = SACActor(obs_shape, action_dim, layers, image_obs=True)
    actor, normalizer, _meta = policy_io.load_policy(model_dir, actor, device)
    actor.eval()
    return config, actor, normalizer


def run(args):
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    set_precision()
    config, actor, normalizer = load_bundle_actor(args.npz, device)
    evaluator = Evaluator(config, device)
    t0 = time.perf_counter()
    res = evaluator.evaluate(actor, normalizer, n_episodes=args.episodes,
                             validate=not args.test, stochastic=args.stochastic)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    print("{:<13}{:>7.2f}".format("Mean reward:", res["mean_return"]))
    print("{:<13}{:>7.2f}".format("Mean steps:", res["mean_length"]))
    print("{:<13}{:>7.2f}".format("Mean success rate:", res["success_rate"]))
    print("{:<13}{:>7.2f}".format("Wall seconds:", wall))
    res["wall_seconds"] = wall
    return res


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(required=True)
    rp = sub.add_parser("run", help="evaluate a committed policy bundle")
    rp.add_argument("--npz", type=str, required=True,
                    help="policy bundle dir (policy.npz + config.yaml)")
    rp.add_argument("-t", "--test", action="store_true")
    rp.add_argument("-s", "--stochastic", action="store_true")
    rp.add_argument("--episodes", type=int, default=100)
    rp.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    rp.set_defaults(func=run)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
