#!/usr/bin/env python3
"""Run chip_smoke.py of several checkouts in turn on one card, and sum up
what each run measured.

    python3 -m deep_rl_grasping_tpu_torch.tools.ab_smoke \\
        parent=DIR change=. change=. parent=DIR --out OUT

Each LABEL=DIR runs `python3 chip_smoke.py` in DIR, in the order given (for
a comparison: parent, change, change, parent), each in its own process
with its own build. Each run's whole output goes to OUT/<n>_<label>.log;
one JSON line per run gives its exit code, wall seconds, the solver
kernel's ms per launch and plain ms at each path's shapes, the raster's
ms per launch with and without shade (device time where the run's smoke
times on the device, and `call_ms` where it logs one), the solver's
registers and stack bytes as ptxas reported them, the eval wall seconds and control
steps of `run --npz`, the same-scene eval where the run has one, and the
training phase's ms per env step and per SAC update. The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time


def phases(text):
    out = {}
    for line in text.splitlines():
        if line.startswith('{"phase"'):
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            out.setdefault(d["phase"], []).append(d)
    return out


def summary(text):
    ph = phases(text)
    s = {}
    for d in ph.get("solver", []):
        s[f"solver_ms_{d['path']}"] = d["kernel_ms"]
        s[f"solver_plain_ms_{d['path']}"] = d["plain_ms"]
        s[f"solver_max_abs_err_{d['path']}"] = d["max_abs_err"]
    for name in ("raster", "raster_shade"):
        for d in ph.get(name, []):
            s[f"{name}_ms_{d['path']}"] = d["kernel_ms"]
            s[f"{name}_call_ms_{d['path']}"] = d.get("call_ms")
    build = ph.get("build", [{}])[0].get("ptxas", [])
    lines = build.get("solver.cu", []) if isinstance(build, dict) else build
    regs = [int(m) for ln in lines for m in re.findall(r"Used (\d+) registers", ln)]
    stack = [int(m) for ln in lines for m in re.findall(r"(\d+) bytes stack frame", ln)]
    # the solver kernel is the largest user of registers in its source
    if regs:
        s["solver_registers_ptxas"] = max(regs)
        s["solver_stack_bytes_ptxas"] = stack[regs.index(max(regs))] if stack else None
    for d in ph.get("solver_resources", []):
        s["solver_resources"] = {k: v for k, v in d.items() if k not in ("phase", "elapsed_s")}
    for d in ph.get("eval", []):
        s.update(eval_wall_s=d["wall_seconds"], eval_control_steps=d["control_steps"],
                 eval_ms_per_control_step=d["wall_seconds"] / d["control_steps"] * 1e3,
                 eval_success_rate=d["success_rate"])
    for d in ph.get("eval_same_scenes", []):
        s.update(same_scene_success_rate=d["success_rate"],
                 same_scene_wall_s=d["wall_seconds"], same_scene_repeat_equal=d["repeat_equal"])
    for d in ph.get("train", []):
        s.update(train_ms_per_env_step=d["ms_per_env_step"],
                 # `ms_per_sac_update` in the logs of trees before the Q-learners
                 train_ms_per_update=d.get("ms_per_update", d.get("ms_per_sac_update")),
                 train_iteration_frames_per_s=d["iteration_frames_per_s"],
                 train_end_to_end_frames_per_s=d["end_to_end_frames_per_s"],
                 train_wall_s=d["wall_seconds"])
    return s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("runs", nargs="+", help="LABEL=DIR, run in this order")
    ap.add_argument("--out", required=True, help="directory for each run's whole output")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    rc_all = 0
    for n, spec in enumerate(args.runs):
        label, tree = spec.split("=", 1)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, capture_output=True,
                              text=True)
        wall = time.perf_counter() - t0
        with open(os.path.join(args.out, f"{n}_{label}.log"), "w") as f:
            f.write(proc.stdout + "\n--- stderr\n" + proc.stderr)
        rc_all = rc_all or proc.returncode
        print(json.dumps({"run": n, "label": label, "tree": tree, "rc": proc.returncode,
                          "wall_s": wall, **summary(proc.stdout)}), flush=True)
    return rc_all


if __name__ == "__main__":
    sys.exit(main())
