#!/usr/bin/env python3
"""Device time and agreement of the raster kernel, and of another tree's
version of it, on the main paths' inputs (CUDA).

    python3 -m deep_rl_grasping_tpu_torch.tools.raster_probe \\
        [--other-raster path/to/csrc/raster.cu]

Builds the inputs as chip_smoke.py's raster checks build them (the solver
check's seed-0 scenes, settled through the solver kernel, advanced by the
plain solver, the grippers yawed over the whole circle) at two shapes:

* eval: the r5c bundle's config, B=100, depth + seg, the nominal camera;
* train: configs/sac_rgbd_flagship.yaml, B=128, with shade, a randomized
  camera pose and intrinsics per env.

On each, the kernels run in turns, each twice in mirrored order (other,
change, change, other): `other` is --other-raster's source built with the
same nvcc flags into the build directory (an older kernel reads only the C
entry's first six ints). Each turn logs the
device ms per launch (chip_smoke.device_ms: 50 launches in one CUDA
graph), the ms per Python call (chip_smoke.cuda_ms, `call_ms`) and per
call with the gathers of `kernel_inputs` (`with_gather_ms`, as
render_batch calls the kernel). Then,
per shape: every kernel against the plain version by the smoke's
criteria, the other kernel against this one (seg mismatches, largest
depth and shade gaps), whether this tree's culled and cull-off launches
and a repeat are bit-equal, the tile lists this tree's kernel writes
against the plain twin of its cull, and the share of pixel-sphere pairs
they hold (the pairs the culled kernel tests). Last, for every kernel and
shape, the profiler's device ms beside the graph's, as a cross-check of
the two methods, and the ms per Python call again (after everything
else: a profiler session slows later launches on the host). One JSON line per result; the card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from deep_rl_grasping_tpu_torch.envs.grasp_env import GraspEnv  # noqa: E402
from deep_rl_grasping_tpu_torch.ops import build, raster_cuda  # noqa: E402
from deep_rl_grasping_tpu_torch.render import raycast  # noqa: E402
from deep_rl_grasping_tpu_torch.sim import physics  # noqa: E402
from deep_rl_grasping_tpu_torch.utils import config as cfg_util  # noqa: E402


def emit(**kv):
    print(json.dumps(kv), flush=True)


def profiler_ms(fn, reps=cs.DEVICE_REPS):
    """Mean device ms of one raster_kernel launch over `reps` calls of fn(),
    from torch.profiler (`self_device_time_total` in `key_averages()`);
    None where the profiler saw no such kernel. A profiler session can
    leave later launches in the process slower on the host (PERF.md), so
    this runs after every other timing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, n = 0.0, 0
    for ev in prof.key_averages():
        if "raster_kernel" in ev.key:
            total_us += ev.self_device_time_total
            n += ev.count
    return total_us / n / 1e3 if n and total_us > 0 else None


def shape_inputs(path, dev):
    """(render_batch's arguments, with_shade) of one path's raster check."""
    if path == "eval":
        env = GraspEnv(cfg_util.load_config(os.path.join(REPO, cs.BUNDLE, "config.yaml")),
                       evaluate=True, validate=True, device=dev)
        B, shade = cs.EPISODES, False
    else:
        env = GraspEnv(cfg_util.load_config(os.path.join(REPO, cs.TRAIN_CONFIG)), device=dev)
        B, shade = int(env.config["tpu"]["num_envs"]), True
    st, gen = cs.solver_check_scenes(env, B, cs.SOLVER_SEEDS[0])
    out_p = physics.run(st, env.sim_params, env.gripper_substeps)
    _, args = cs.raster_scenes(env, B, out_p, gen)
    return args, shade, env.near


def against_plain(out, plain, candidates):
    """The smoke's raster and shade criteria of one kernel's outputs."""
    d_k, s_k = out[0], out[1]
    d_p, s_p, _ = plain
    n = s_k.numel()
    same = s_k == s_p
    err = (d_k - d_p).abs()[same]
    res = {"seg_mismatch_px": int((~same).sum()), "depth_max_abs_err": float(err.max()),
           "depth_px_over_tol": int((err > cs.DEPTH_TOL).sum())}
    ok = (res["seg_mismatch_px"] <= cs.SEG_MISMATCH_FRAC * n
          and res["depth_max_abs_err"] <= cs.DEPTH_EDGE_TOL
          and res["depth_px_over_tol"] <= cs.DEPTH_OVER_FRAC * n)
    if len(out) == 3:
        gap = raycast.shade_gap(s_k, out[2], candidates, cs.DEPTH_TOL)[same]
        res.update(shade_max_abs_err=float(gap.max()),
                   shade_px_over_tol=int((gap > cs.SHADE_TOL).sum()))
        ok = ok and (res["shade_max_abs_err"] <= cs.SHADE_EDGE_TOL
                     and res["shade_px_over_tol"] <= cs.SHADE_OVER_FRAC * n)
    res["within_smoke_tolerances"] = bool(ok)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other-raster", help="another tree's csrc/raster.cu to time beside this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("raster_probe: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    emit(card=smi.stdout.strip(), tile=raster_cuda.TILE)
    kernels = {"change": build.library()}
    if args.other_raster:
        kernels = {"other": build.load_source(args.other_raster, "other"), **kernels}
    order = list(kernels) + list(reversed(kernels))
    cross_checks = []
    for path in ("eval", "train"):
        r_args, shade, near = shape_inputs(path, dev)
        ins, kw = raster_cuda.kernel_inputs(*r_args)
        B, P = ins[0].shape[:2]

        def run(label, cull=True, lists=False, ins=ins, kw=kw, shade=shade):  # this shape
            return raster_cuda.launch(ins, **kw, with_shade=shade, cull=cull, lists=lists,
                                      lib=kernels[label])

        def gathered(label, r_args=r_args, shade=shade):  # as render_batch calls it
            k_ins, k_kw = raster_cuda.kernel_inputs(*r_args)
            return raster_cuda.launch(k_ins, **k_kw, with_shade=shade, lib=kernels[label])

        for turn, label in enumerate(order):
            fn = lambda: run(label)
            call_ms = cs.cuda_ms(fn, 50, torch)
            with_gather_ms = cs.cuda_ms(lambda: gathered(label), 20, torch)
            emit(path=path, B=B, P=P, with_shade=shade, turn=turn, kernel=label,
                 timing="cuda_graph",
                 device_ms=cs.device_ms(fn, torch), call_ms=call_ms,
                 with_gather_ms=with_gather_ms)
        cross_checks += [(path, label, functools.partial(run, label)) for label in kernels]
        plain = raycast.render_shade(*r_args, with_shade=shade)
        candidates = raycast.hit_candidates(*r_args[:7], near) if shade else None
        outs = {label: run(label) for label in kernels}
        for label, out in outs.items():
            emit(path=path, kernel=label, against_plain=against_plain(out, plain, candidates))
        mine = outs["change"]
        off = run("change", cull=False)
        *again, lists = run("change", lists=True)
        row = {"cull_off_bit_equal": all(torch.equal(a, b) for a, b in zip(mine, off)),
               "repeat_bit_equal": all(torch.equal(a, b) for a, b in zip(mine, again)),
               "lists_vs_twin": raster_cuda.check_lists(lists, ins[0], ins[1], ins[5], ins[6],
                                                        ins[7], kw["H"], kw["W"]),
               "pairs_tested": raster_cuda.pairs_tested(lists, kw["H"], kw["W"]),
               "live_pairs": float((ins[1] > 0).double().mean())}
        if "other" in outs:
            o = outs["other"]
            same = o[1] == mine[1]
            row["other_vs_change"] = {
                "seg_mismatch_px": int((~same).sum()),
                "depth_max_abs_gap": float((o[0] - mine[0]).abs()[same].max()),
                "shade_max_abs_gap": float((o[2] - mine[2]).abs()[same].max()) if shade else None}
        emit(path=path, B=B, P=P, **row)
    for path, label, fn in cross_checks:
        prof_ms = profiler_ms(fn)
        call_ms = cs.cuda_ms(fn, 50, torch)
        emit(path=path, kernel=label, timing="profiler", profiler_ms=prof_ms,
             device_ms=cs.device_ms(fn, torch), call_ms_after_profiler=call_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
