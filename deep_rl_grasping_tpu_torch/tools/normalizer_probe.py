"""The data-parallel learning pair's final checkpoints, probed: does the gap
between the two-rank run and the one-device run repeat on another seed,
and does it come from the per-rank observation normalizer?

Trains, from one seed, the one-device run of `--single` and the two-rank
run of `--sharded` (two gloo ranks on one device, through
`train_dp.launch_train`), then evaluates on `--episodes` protocol
episodes at curriculum lambda 1:

* `single`: the one-device run's final checkpoint with its normalizer;
* `w2_rank0`: the two-rank run's final checkpoint (rank 0's learner) with
  rank 0's normalizer, which is what the checkpoint holds;
* `w2_rank1`: the same learner with rank 1's observation moments;
* `w2_merged`: the same learner with both ranks' moments merged (Chan's
  parallel combination, as `algos/normalize.py` folds a batch).

Each evaluation draws the same scenes (the evaluator's generator is
seeded with 1). Prints one JSON line per evaluation and a summary line
with both runs' window success rates and the ranks' normalizer gap
(largest |mean_0 - mean_1| in units of the merged standard deviation).

    python -m deep_rl_grasping_tpu_torch.tools.normalizer_probe --seed 1 \\
        --timestep 65536 --episodes 500 --out <dir>

`<dir>/single` and `<dir>/w2` get the two runs' directories. Runs on the
card unless `--device cpu` is given; `--sharded` and `--single` name
another config pair (a tiny one for a CPU check).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import torch

from deep_rl_grasping_tpu_torch.algos.normalize import EPS, RunningMeanStd
from deep_rl_grasping_tpu_torch.parallel import train_dp
from deep_rl_grasping_tpu_torch.training import train
from deep_rl_grasping_tpu_torch.training.trainer import Evaluator

SHARDED = "configs/sac_simplified_sharded_quality.yaml"
SINGLE = "configs/sac_simplified_singlechip_quality.yaml"


def merge_rms(a: RunningMeanStd, b: RunningMeanStd) -> RunningMeanStd:
    """The moments of both sample sets, from each set's moments."""
    tot = a.count + b.count
    delta = b.mean - a.mean
    m2 = a.var * a.count + b.var * b.count + delta ** 2 * a.count * b.count / tot
    return RunningMeanStd(mean=a.mean + delta * b.count / tot, var=m2 / tot, count=tot)


def evaluate(name, model_dir, device, episodes, obs_rms=None):
    """`run --model`'s evaluation of `model_dir`'s final checkpoint, with
    `obs_rms` in place of the checkpoint's observation moments if given."""
    config, actor, normalizer = train.load_checkpoint_actor(model_dir, device)
    if obs_rms is not None:
        normalizer = normalizer.replace(obs_rms=obs_rms)
    t0 = time.perf_counter()
    res = Evaluator(config, device).evaluate(actor, normalizer, n_episodes=episodes)
    out = dict(eval=name, episodes=episodes, success_rate=float(res["success_rate"]),
               mean_return=float(res["mean_return"]), mean_length=float(res["mean_length"]),
               seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--timestep", type=int, default=65536)
    p.add_argument("--episodes", type=int, default=500)
    p.add_argument("--out", required=True)
    p.add_argument("--sharded", default=SHARDED)
    p.add_argument("--single", default=SINGLE)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = train._device(args.device)
    common = ["--algo", "SAC", "--timestep", str(args.timestep), "--seed", str(args.seed),
              "--device", device.type]
    w2_dir, single_dir = os.path.join(args.out, "w2"), os.path.join(args.out, "single")
    rank_device = "cpu" if device.type == "cpu" else f"cuda:{device.index or 0}"
    ranks = train_dp.launch_train(["train", "--config", args.sharded, "--model_dir", w2_dir]
                                  + common, 2, "gloo", [rank_device] * 2)
    single = train.main(["train", "--config", args.single, "--model_dir", single_dir] + common)

    rms = [RunningMeanStd(**{k: v.to(device) for k, v in r["obs_rms"].items()}) for r in ranks]
    merged = merge_rms(*rms)
    gap = float(((rms[0].mean - rms[1].mean).abs() / torch.sqrt(merged.var + EPS)).max())
    ckpt_rms = train.load_checkpoint_actor(w2_dir, device)[2].obs_rms
    rank0_in_checkpoint = all(torch.equal(getattr(ckpt_rms, f), getattr(rms[0], f))
                              for f in ("mean", "var", "count"))
    evals = [evaluate("single", single_dir, device, args.episodes),
             evaluate("w2_rank0", w2_dir, device, args.episodes),
             evaluate("w2_rank1", w2_dir, device, args.episodes, rms[1]),
             evaluate("w2_merged", w2_dir, device, args.episodes, merged)]
    summary = dict(seed=args.seed, frames=[single["frames"], ranks[0]["result"]["frames"]],
                   window_success_rate={"single": single["success_rate"],
                                        "w2": ranks[0]["result"]["success_rate"]},
                   curriculum_lambda={"single": single["curriculum_lambda"],
                                      "w2": ranks[0]["result"]["curriculum_lambda"]},
                   normalizer_mean_gap_in_std=gap, rank0_in_checkpoint=rank0_in_checkpoint,
                   success_rate={e["eval"]: e["success_rate"] for e in evals},
                   card=train.card_info(device))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
