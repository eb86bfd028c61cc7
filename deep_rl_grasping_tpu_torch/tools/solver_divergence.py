#!/usr/bin/env python3
"""Where the solver kernel and its plain version part, on the card (CUDA).

    python3 -m deep_rl_grasping_tpu_torch.tools.solver_divergence \\
        [--other-solver path/to/solver.cu] [--trace PATH:SEED:ENV ...]

Uses the scenes of chip_smoke.py's solver check (`solver_check_scenes`:
drawn from a seed, settled through the kernel, half the envs closing the
fingers on an object) on its two paths (eval: the r5c bundle's config,
B=100; train: configs/sac_rgbd_flagship.yaml, B=128). Prints one JSON line
per result:

* for each path and seed in range(SEEDS): the envs whose gap to the plain
  version passes chip_smoke.SOLVER_TOL after SHORT_SUBSTEPS and after the
  path's n_substeps, with the largest angular-velocity gap; with
  --other-solver also for that source's kernel (built by build.load_source; it is
  launched through the same C entry arguments, of which the parent's
  one-thread-per-env kernel reads what it needs) and between the two;
* for each --trace PATH:SEED:ENV, after each substep 1..n_substeps: that
  env's largest angular-velocity gap of the kernel (and the other kernel)
  to the plain version, and of each, the plain version included, to the
  plain version run in float64 on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from deep_rl_grasping_tpu_torch.envs.grasp_env import GraspEnv  # noqa: E402
from deep_rl_grasping_tpu_torch.ops import build, solver_cuda  # noqa: E402
from deep_rl_grasping_tpu_torch.sim import physics  # noqa: E402
from deep_rl_grasping_tpu_torch.utils import config as cfg_util  # noqa: E402

SEEDS = 8

def emit(**kv):
    print(json.dumps(kv), flush=True)


def other_kernel(source, dev):
    """A function running another source's solver kernel on a state."""
    lib = build.load_source(source, "other")

    def run(state, params, n_sub):
        ins = solver_cuda.kernel_inputs(state, params)
        B, K, S = ins[10].shape
        SC = ins[12].shape[2]
        cfg = solver_cuda.launch_config(B, K, S, SC, bool(params.has_tray))
        ip = solver_cuda.int_params(B, K, S, SC, n_sub, params, cfg["threads"],
                                    cfg["shared_bytes"])
        outs = [torch.empty_like(t) for t in (ins[0], ins[1], ins[4], ins[5], ins[6], ins[7])]
        build.check(lib.solver_run(solver_cuda._float_params(params).ctypes.data,
                                   ip.ctypes.data, *[t.data_ptr() for t in ins],
                                   *[o.data_ptr() for o in outs],
                                   torch.cuda.current_stream(dev).cuda_stream), source)
        g, o = state.gripper, state.objects
        return state.replace(gripper=g.replace(q=outs[0], qd=outs[1]),
                             objects=o.replace(pos=outs[2], quat=outs[3], linvel=outs[4],
                                               angvel=outs[5]))
    return run


def over_tol(a, b):
    """Envs where a and b differ by more than SOLVER_TOL; largest angvel gap."""
    gaps = cs.solver_gaps(a, b)
    bad = torch.zeros_like(gaps["q"], dtype=torch.bool)
    for name, g in gaps.items():
        bad |= ~(g <= cs.SOLVER_TOL[name])
    return {"envs": torch.nonzero(bad).flatten().tolist(),
            "max_angvel_gap": float(gaps["angvel"].max())}


def to_float(x, dtype):
    """A state or params with every floating tensor cast to dtype."""
    cast = {f.name: getattr(x, f.name).to(dtype) for f in dataclasses.fields(x)
            if torch.is_tensor(getattr(x, f.name)) and getattr(x, f.name).is_floating_point()}
    return x.replace(**cast)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-solver", help="another tree's csrc/solver.cu to compare as well")
    ap.add_argument("--trace", nargs="*", default=[], help="PATH:SEED:ENV, e.g. train:1:56")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("solver_divergence: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    emit(card=smi.stdout.strip())
    other = other_kernel(args.other_solver, dev) if args.other_solver else None
    paths = {"eval": (GraspEnv(cfg_util.load_config(os.path.join(REPO, cs.BUNDLE, "config.yaml")),
                               evaluate=True, validate=True, device=dev), cs.EPISODES),
             "train": (GraspEnv(cfg_util.load_config(os.path.join(REPO, cs.TRAIN_CONFIG)),
                                device=dev), 128)}
    for path, (env, B) in paths.items():
        p, n_sub = env.sim_params, env.gripper_substeps
        for seed in range(SEEDS):
            st, _ = cs.solver_check_scenes(env, B, seed)
            row = {}
            for n in (cs.SHORT_SUBSTEPS, n_sub):
                plain = physics.run(st, p, n)
                kern = solver_cuda.run_batched_sim(st, p, n)
                row[f"kernel_{n}"] = over_tol(kern, plain)
                if other is not None:
                    oth = other(st, p, n)
                    row[f"other_{n}"] = over_tol(oth, plain)
                    row[f"kernel_vs_other_{n}"] = over_tol(kern, oth)
            emit(path=path, B=B, seed=seed, **row)
    for spec in args.trace:
        path, seed, e = spec.split(":")
        env, B = paths[path]
        p, n_sub = env.sim_params, env.gripper_substeps
        st, _ = cs.solver_check_scenes(env, B, int(seed))
        st64 = st.replace(gripper=to_float(st.gripper, torch.float64),
                          objects=to_float(st.objects, torch.float64))
        p64 = to_float(p, torch.float64)
        e = int(e)
        for n in range(1, n_sub + 1):
            plain = physics.run(st, p, n)
            ref = physics.run(st64, p64, n).objects.angvel.float()
            runs = {"kernel": solver_cuda.run_batched_sim(st, p, n), "plain": plain}
            if other is not None:
                runs["other"] = other(st, p, n)
            gap = lambda a, b: float((a.objects.angvel[e] - b[e]).abs().max())
            emit(trace=spec, substeps=n,
                 angvel_gap_to_plain={k: gap(v, plain.objects.angvel) for k, v in runs.items()
                                      if k != "plain"},
                 angvel_gap_to_float64_plain={k: gap(v, ref) for k, v in runs.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
