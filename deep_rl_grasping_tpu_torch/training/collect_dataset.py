"""Depth-image dataset collection for autoencoder training (port of
deep_rl_grasping_tpu/training/collect_dataset.py: `masked_depth` :35,
`collect` :47, the CLI :106).

The batched env rolls out a uniform random continuous policy; after every
control step each env's masked depth image (the support surface, the tray
and the gripper zeroed through the render's seg ids, train_encoder.py:19-27
of the reference) is one image. The step and the render go through the
solver and raster kernels on the card (the JAX package steps its
single-env XLA path under vmap). Every `steps_per_reset` steps all envs
are reset, at curriculum lambda 1, or with `mix_lambda` at a lambda drawn
per reset so that the images cover the whole curriculum.

    python -m deep_rl_grasping_tpu_torch.training.collect_dataset \\
        --config configs/sac_full_flagship.yaml --keep_task --mix_lambda \\
        --out encoder_files/<name>_dataset.npz --train 18000 --test 2000

writes float32 `train` and `test` arrays of shape (N, 64, 64, 1). Without
`--keep_task` the task is made the simplified one (the reference
collector's descend policy env). Runs on the card unless `--device cpu`
is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from deep_rl_grasping_tpu_torch.envs.grasp_env import BatchedGraspEnv, GraspEnv
from deep_rl_grasping_tpu_torch.ops import raster_cuda
from deep_rl_grasping_tpu_torch.render import raycast
from deep_rl_grasping_tpu_torch.utils import config as cfg_util


def masked_depth(env: GraspEnv, states):
    """(B, H, W) depth images of a batch of env states with the support,
    the tray and the gripper zeroed (train_encoder.py:19-27): the encoder's
    input, `GraspEnv.encoder_input`, of the batched render."""
    cam_pos, cam_R = raycast.camera_pose_from_gripper(states.sim.gripper.q, states.cam_t,
                                                      states.cam_R)
    depth, seg = raster_cuda.render_batch(states.sim, env.sim_params, cam_pos, cam_R,
                                          states.intrinsics, H=env.im_h, W=env.im_w,
                                          near=env.near, far=env.far)
    return env.encoder_input(depth, seg)


def collect_env(config, keep_task=False, device="cuda"):
    """The collector's env: the config's task (`keep_task`) or the
    simplified one, with continuous actions. The collector reads the render,
    not the observation, so the env observes depth (no encoder needed)."""
    cfg = cfg_util.load_config(config)
    if not keep_task:
        cfg["simplified"] = True
    cfg["robot"]["discrete"] = False
    cfg["depth_observation"], cfg["full_observation"] = True, False
    return GraspEnv(cfg, device=device)


def collect(config, n_images, num_envs=128, steps_per_reset=20, keep_task=False,
            mix_lambda=False, device="cuda"):
    """`n_images` masked depth images (n_images, H, W) on `device`, drawn
    with a generator seeded by 0 (collect_dataset.py:47-103)."""
    env = collect_env(config, keep_task, device)
    gen = torch.Generator(device=device).manual_seed(0)
    benv = BatchedGraspEnv(env, num_envs, gen)
    out, total = [], 0
    while total < n_images:
        lam = float(torch.rand((), generator=gen, device=device)) if mix_lambda else 1.0
        states = env.reset_env(gen, num_envs, lam, settle_substeps=48)
        for _ in range(steps_per_reset):
            actions = torch.rand((num_envs, env.action_dim), generator=gen, device=device) * 2 - 1
            stepped, reward, status = benv.step_core(states, actions)
            states, _, _, _ = env._finalize_step(gen, states, stepped, reward, status, lam)
            out.append(masked_depth(env, states))
            total += num_envs
        print(f"collected {min(total, n_images)}/{n_images}", flush=True)
    return torch.cat(out)[:n_images]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/simplified_object_picking.yaml")
    p.add_argument("--out", default="encoder_files/dataset.npz")
    p.add_argument("--train", type=int, default=18000)
    p.add_argument("--test", type=int, default=2000)
    p.add_argument("--num_envs", type=int, default=128)
    p.add_argument("--device", default="cuda")
    p.add_argument("--keep_task", action="store_true",
                   help="keep the config's task (no simplified override); use for full-task "
                        "datasets")
    p.add_argument("--mix_lambda", action="store_true",
                   help="draw the curriculum lambda per reset instead of pinning lambda=1")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    t0 = time.perf_counter()
    imgs = collect(args.config, args.train + args.test, args.num_envs, keep_task=args.keep_task,
                   mix_lambda=args.mix_lambda, device=device)
    imgs = imgs.cpu().numpy().astype(np.float32)[..., None]
    collect_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez_compressed(args.out, train=imgs[:args.train], test=imgs[args.train:])
    print(f"wrote {args.out}: train {args.train}, test {args.test}")
    return dict(path=args.out, images=int(imgs.shape[0]), collect_seconds=collect_s,
                nonzero_px_frac=float((imgs > 0).mean()))


if __name__ == "__main__":
    main()
