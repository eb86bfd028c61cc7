#!/usr/bin/env python3
"""Where a training iteration's time goes on the folded-update config
(configs/sac_simplified_batched_quality.yaml), per iteration and per
kernel family, at 128 and 256 envs (CUDA).

    python3 -m deep_rl_grasping_tpu_torch.tools.step_probe

For each env count the config's trainer is built at that width (SAC, seed
0, `learning_starts` 0 so that every iteration updates), seeded with
DEMO_FRAMES demo frames, and run for ITERATIONS iterations of
`Trainer.train_step` in chunks of the config's `chunk_steps`, as `train`
runs them. Logged per iteration: the env-step and update intervals of the
trainer's own clock (CUDA events) and the host's wall time. Then the env
step alone (`BatchedGraspEnv.step` on the trainer's states with uniform
random actions) runs PROFILE_STEPS times under torch.profiler: device time
per control step of the solver kernel, the raster kernel, convolutions
and everything else, the number of device kernels launched, and the
host's wall time per step beside the summed device time (the rest is
time the card waits for the host). One JSON line per result; the card's
name and power limit come first.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from deep_rl_grasping_tpu_torch.training.train import make_trainer, set_precision
from deep_rl_grasping_tpu_torch.utils import config as cfg_util

CONFIG = "configs/sac_simplified_batched_quality.yaml"
NUM_ENVS = (128, 256)
ITERATIONS = 24
DEMO_FRAMES = 2048
PROFILE_STEPS = 8


def emit(**kv):
    print(json.dumps(kv), flush=True)


def family(name):
    """The kernel family a device kernel's name belongs to."""
    if "solver_kernel" in name:
        return "solver"
    if "raster_kernel" in name:
        return "raster"
    if any(s in name.lower() for s in ("conv", "cudnn", "xmma", "implicit_gemm", "wgrad",
                                       "dgrad", "fprop")):
        return "conv"
    return "other"


def iteration_times(trainer, state, iterations, chunk):
    """Per-iteration (env ms, update ms, host ms) over `iterations`
    train_step calls, folded every `chunk` calls as train_chunk does."""
    rows = []
    while len(rows) < iterations:
        host = []
        for _ in range(min(chunk, iterations - len(rows))):
            t0 = time.perf_counter()
            state, _ = trainer.train_step(state)
            host.append((time.perf_counter() - t0) * 1e3)
        pending = list(trainer.clock.pending)
        trainer.clock.fold()
        env = [a.elapsed_time(b) for ph, a, b in pending if ph == "env"]
        upd = [a.elapsed_time(b) for ph, a, b in pending if ph == "update"]
        upd += [0.0] * (len(env) - len(upd))
        rows += list(zip(env, upd, host))
    return state, rows


def profile_env_step(trainer, state, steps, gen):
    """Device ms per control step by kernel family, kernels per step and
    host ms per step of `steps` env steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    benv, B = trainer.benv, trainer.num_envs
    act_dim = trainer.env.action_dim
    st, cur = state.env_states, state.curriculum
    with torch.no_grad():
        st, _, _, _, _, cur = benv.step(st, torch.rand(B, act_dim, generator=gen,
                                                       device=trainer.device) * 2 - 1, cur)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                a = torch.rand(B, act_dim, generator=gen, device=trainer.device) * 2 - 1
                st, _, _, _, _, cur = benv.step(st, a, cur)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / steps
    fam, n_kernels = {}, 0
    for ev in prof.key_averages():
        if ev.self_device_time_total <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        f = family(ev.key)
        fam[f] = fam.get(f, 0.0) + ev.self_device_time_total / 1e3 / steps
        n_kernels += ev.count
    return dict(device_ms_per_step=fam, device_ms_total=sum(fam.values()),
                kernels_per_step=n_kernels / steps, host_ms_per_step=host_ms)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("step_probe needs a CUDA device")
    set_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    emit(card=smi.stdout.strip(), torch=torch.__version__)
    dev = torch.device("cuda")
    for n in NUM_ENVS:
        cfg = cfg_util.load_config(CONFIG)
        cfg["tpu"]["num_envs"] = n
        cfg["SAC"]["learning_starts"] = 0
        trainer = make_trainer(cfg, "SAC", dev, 0)
        state = trainer.init_state()
        state, _, _ = trainer.seed_demos(state, DEMO_FRAMES)
        chunk = max(int(cfg["tpu"].get("chunk_steps", 20)), 1)
        state, rows = iteration_times(trainer, state, ITERATIONS, chunk)
        env, upd, host = ([r[i] for r in rows] for i in range(3))
        tail = slice(chunk, None)
        mean = lambda xs: sum(xs) / max(len(xs), 1)
        emit(num_envs=n, config=CONFIG, updates_per_step=trainer.updates_per_step,
             batch_size=trainer.batch_size, iterations=len(rows), env_ms=env, update_ms=upd,
             host_ms=host, env_ms_first=env[0], env_ms_mean_after_first_chunk=mean(env[tail]),
             update_ms_mean_after_first_chunk=mean(upd[tail]),
             host_ms_mean_after_first_chunk=mean(host[tail]))
        gen = torch.Generator(device=dev).manual_seed(1)
        emit(num_envs=n, env_step_profile=profile_env_step(trainer, state, PROFILE_STEPS, gen))
        del trainer, state
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
