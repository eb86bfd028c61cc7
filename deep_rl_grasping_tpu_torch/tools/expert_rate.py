"""The scripted expert's success rate on a config's task, the rate behind
its demo seeding (the reference's expert probes, scripts_dev/
probe_expert_rate.py of the JAX package).

`n_episodes` training envs (the training object split, as demo seeding
draws them) start at curriculum lambda `lam`; each runs the expert that
`Trainer.seed_demos` would use for SAC on the task (`scripted_full_action`
or `scripted_simplified_action`, exploration noise 0.1 and 10% random
actions) until its first episode ends or the time horizon. Per episode:
success, length, and on table clearing the objects cleared (its first
alive count minus the post-step count at its end).

    python -m deep_rl_grasping_tpu_torch.tools.expert_rate \\
        --config configs/sac_table_clearing.yaml --lam 0 --episodes 128

Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from deep_rl_grasping_tpu_torch.envs import scripted
from deep_rl_grasping_tpu_torch.envs.grasp_env import BatchedGraspEnv, GraspEnv
from deep_rl_grasping_tpu_torch.training.trainer import FirstEpisodes
from deep_rl_grasping_tpu_torch.utils import config as cfg_util


@torch.no_grad()
def expert_rollouts(config, n_episodes=128, lam=0.0, device="cuda"):
    """Per-episode results of the expert at lambda `lam`: the dict of
    `FirstEpisodes.summary()` (success rate, mean objects cleared, mean
    length, the per-episode lists), the control steps run and the wall
    seconds."""
    cfg = cfg_util.load_config(config)
    cfg["robot"]["discrete"] = False
    device = torch.device(device)
    env = GraspEnv(cfg, device=device)
    expert = scripted.scripted_simplified_action if env.simplified else \
        scripted.scripted_full_action
    gen = torch.Generator(device=device).manual_seed(0)
    act_gen = torch.Generator(device=device).manual_seed(1)
    benv = BatchedGraspEnv(env, n_episodes, gen)
    cur = benv.init_curriculum()
    cur = cur.replace(lam=torch.full_like(cur.lam, float(lam)))
    t0 = time.perf_counter()
    states, _ = benv.reset(cur)
    first = FirstEpisodes(states)
    t = 0
    while t < env.time_horizon and not first.all_done():
        actions = expert(env, states, act_gen)
        stepped, reward, status = benv.step_core(states, actions)
        states, _, dones, infos = env._finalize_step(gen, states, stepped, reward, status,
                                                     float(lam))
        first.record(dones, infos)
        t += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dict(first.summary(), lam=float(lam), control_steps=t,
                wall_seconds=time.perf_counter() - t0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--lam", type=float, default=0.0)
    p.add_argument("--episodes", type=int, default=128)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    res = expert_rollouts(args.config, args.episodes, args.lam, args.device)
    print(json.dumps({k: v for k, v in res.items() if not k.startswith("episode_")}))
    return res


if __name__ == "__main__":
    main()
