"""Export a run of the port's `train` to a policy bundle in the JAX
package's layout (the counterpart of scripts/export_policy.py).

    python -m deep_rl_grasping_tpu_torch.tools.export_policy <run_dir> \
        [--out trained/<name>] [--latest] [--device cuda|cpu]

Reads the best checkpoint of <run_dir> (the latest when the run has no
best one, or with --latest) and writes <out>/policy.npz (utils/policy_io.py
`save_policy`), config.yaml (the run's config, through the port's YAML
writer) and PROVENANCE.md: the checkpoint, and for every `train` call of
the run (<run_dir>/runs.jsonl) its command, seed, card with power limit,
frames and wall seconds. Like the JAX script it builds the learner without
a replay ring. It runs on the card unless `--device cpu` is given. Either
package evaluates the bundle:

    python -m deep_rl_grasping_tpu_torch.training.train run --npz <out>
    JAX_PLATFORMS=cpu python -m deep_rl_grasping_tpu.training.train run --npz <out>
"""

from __future__ import annotations

import argparse
import json
import os

from deep_rl_grasping_tpu_torch.models.networks import SACActor
from deep_rl_grasping_tpu_torch.training import callbacks as cb
from deep_rl_grasping_tpu_torch.training import train
from deep_rl_grasping_tpu_torch.utils import io_utils, policy_io


def _runs(run_dir):
    path = os.path.join(run_dir, "runs.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def provenance(out_dir, run_dir, source, step, algo, npz_path, runs):
    """The lines of PROVENANCE.md."""
    lines = [f"# {os.path.basename(out_dir)}", "",
             f"- exported from `{run_dir}` ({source} checkpoint, {step} frames) by "
             f"`python -m deep_rl_grasping_tpu_torch.tools.export_policy`",
             f"- algo: {algo}; bundle: `policy.npz` ({os.path.getsize(npz_path) / 1e6:.2f} MB)"]
    if runs:
        resumes = sum(1 for r in runs if r.get("load_dir"))
        lines.append(f"- trained by the port in {len(runs)} `train` call(s), {resumes} of them "
                     "resumed with `--load_dir`:")
        for i, r in enumerate(runs, 1):
            lines.append(f"  {i}. `{r['command']}`: seed {r['seed']}, {r['device']} "
                         f"({r.get('card') or 'no card'}), frames {r['start_frames']} -> "
                         f"{r['frames']}, {r['wall_seconds']:.1f} s, ring rows restored "
                         f"{r.get('ring_rows_restored')}")
    lines += [f"- evaluate: `python -m deep_rl_grasping_tpu_torch.training.train run --npz "
              f"{out_dir}` (the port), or `JAX_PLATFORMS=cpu python -m "
              f"deep_rl_grasping_tpu.training.train run --npz {out_dir}` (the JAX package)"]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--latest", action="store_true",
                    help="export the latest checkpoint instead of the best")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = train._device(args.device)

    run_dir = args.run_dir.rstrip("/")
    out_dir = args.out or os.path.join("trained", os.path.basename(run_dir))
    ckpt = cb.Checkpointer(run_dir)
    best = not args.latest and ckpt.best_step() is not None
    if not args.latest and not best:
        print("no best_model checkpoint; exporting the latest")
    step = ckpt.best_step() if best else ckpt.latest_step()
    config, policy, normalizer = train.load_checkpoint_actor(run_dir, device, best=best)
    net = policy if isinstance(policy, SACActor) else policy.net
    source = "best" if best else "latest"
    path = policy_io.save_policy(out_dir, net, normalizer.obs_rms, normalizer.ret_rms,
                                 dict(source=source, source_dir=run_dir, checkpoint_step=step))
    io_utils.save_yaml(io_utils.load_yaml(os.path.join(run_dir, "config.yaml")),
                       os.path.join(out_dir, "config.yaml"))
    algo = config.get("algorithm", "sac").upper()
    lines = provenance(out_dir, run_dir, source, step, algo, path, _runs(run_dir))
    with open(os.path.join(out_dir, "PROVENANCE.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {path} ({os.path.getsize(path) / 1e6:.2f} MB)")
    return dict(path=path, source=source, checkpoint_step=step, algo=algo)


if __name__ == "__main__":
    main()
