#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `deep_rl_grasping_tpu_torch/csrc` with
plain nvcc, holds each kernel against its plain PyTorch version at the
shapes of the evaluation path, loads the committed flagship SAC bundle, and
runs the port's `run --npz trained/sac_full_flagship_r5c` evaluation
(100 episodes, validation split) through the command-line entry point.
Each phase prints one JSON line with its elapsed seconds. The last three
lines are the card's name and power limit (nvidia-smi), one JSON object
with every kernel's measurements, and the result line
`{"ok": true, "device": {...}}`. Any failure raises and the exit code is
non-zero; without a CUDA device it exits non-zero and prints no result.

Imports only the standard library, numpy, torch and the port.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join("trained", "sac_full_flagship_r5c")
EPISODES = 100  # the evaluation protocol

# Published peaks of one H100 SXM (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

# Tolerances of kernel vs plain version, both on the card, same inputs.
# Solver: the plain version and the kernel add the same per-contact
# impulses in a different order (and nvcc fuses multiply-adds), so float32
# rounding differs from the first substep on and is amplified by the stiff
# pad squeeze; the bounds are those the JAX package holds its own Pallas
# solver to against XLA on a grasp squeeze (tests/test_solver_pallas.py:
# 2e-3 on positions, 20x on velocities, 10x on quaternions; object angular
# velocities, which that test does not hold, to 0.2 rad/s).
SOLVER_TOL = {"q": 2e-3, "qd": 4e-2, "pos": 2e-3, "quat": 2e-2, "linvel": 4e-2, "angvel": 0.2}
# Raster: where the segment ids agree, depth to 1e-4 m on all but 0.5% of
# pixels and to 5e-3 m on every pixel. The loose bound is for edge pixels,
# where the hit distance is ill-conditioned (a square root of a near-zero
# discriminant at a sphere's silhouette, two slab planes crossing at a
# grazing angle on a finger pad's edge), so float32 rounding (fused
# multiply-adds in the kernel, other contractions in the plain version)
# moves it by up to millimetres.
# Ids may differ only where two primitives' hits lie within rounding of
# each other: at most 0.05% of all pixels.
DEPTH_TOL = 1e-4
DEPTH_OVER_FRAC = 5e-3
DEPTH_EDGE_TOL = 5e-3
SEG_MISMATCH_FRAC = 5e-4
# Actor on the card vs the same weights on the CPU: bf16 layers round at
# other places in cuDNN/cuBLAS and in the CPU kernels.
ACTOR_TOL = 5e-2


def log(phase, **kv):
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - T0, 3), **kv}),
          flush=True)


def cuda_ms(fn, reps, torch):
    """Mean milliseconds per call of fn() on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def solver_flops(B, K, S, SC, NS, n_sub, iters, pad_inner, stride):
    """Float operations of one solver call, counted from csrc/solver.cu per
    row: ~70 per static row and ~200 per pad row to build (geometry,
    tangent basis, three effective masses), ~120 per object-pair row; per
    iteration ~60 per static row, per pad pass ~150 per pad pair (coupled
    2x2 solve) + 2 x 80 (friction), ~90 per object-pair row; ~60 per object
    to integrate."""
    KS = K * S
    NOO = K * (K - 1) // 2 * SC * SC
    build = KS * (NS * 70 + 2 * 200) + NOO * 120
    it = iters * (NS * KS * 60 + pad_inner * (30 + KS * (150 + 160)))
    oo = ((iters + stride - 1) // stride) * NOO * 90
    return B * n_sub * (build + it + oo + K * 60)


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from deep_rl_grasping_tpu_torch.envs.grasp_env import GraspEnv
        from deep_rl_grasping_tpu_torch.ops import build, raster_cuda, solver_cuda
        from deep_rl_grasping_tpu_torch.render import raycast
        from deep_rl_grasping_tpu_torch.sim import physics
        from deep_rl_grasping_tpu_torch.sim.types import FINGER_CLOSED
        from deep_rl_grasping_tpu_torch.training import train
        from deep_rl_grasping_tpu_torch.utils import config as cfg_util
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 1
    os.chdir(REPO)
    dev = torch.device("cuda")
    train.set_precision()
    kind = torch.cuda.get_device_name(0)
    log("start", device=kind, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 1. build
    lib = build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "stack frame" in ln]
    log("build", seconds=round(lib.build_seconds, 3), reused=lib.reused, ptxas=ptxas)

    # ---- 2. solver: kernel vs plain version on reset states (B=100, 16 substeps)
    config = cfg_util.load_config(os.path.join(BUNDLE, "config.yaml"))
    env = GraspEnv(config, evaluate=True, validate=True, device=dev)
    params = env.sim_params
    B, n_sub = 100, env.gripper_substeps
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = env.reset_env(gen, B, 1.0, settle_substeps=48).sim
    # Half the batch descends onto object slot 0 and closes the fingers, so
    # the pad rows (the stiff squeeze) are exercised as well as the statics.
    half = torch.arange(B, device=dev) >= B // 2
    q = st.gripper.q.clone()
    q[half, 0:2] = st.objects.pos[half, 0, 0:2]
    q[half, 2] = 0.07
    g = st.gripper.replace(
        q=q, target=q[:, :4].clone(),
        finger_target=torch.where(half, FINGER_CLOSED, st.gripper.finger_target))
    st = st.replace(gripper=g)
    out_k = solver_cuda.run_batched_sim(st, params, n_sub)
    out_p = physics.run(st, params, n_sub)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in (("q", out_k.gripper.q, out_p.gripper.q),
                       ("qd", out_k.gripper.qd, out_p.gripper.qd),
                       ("pos", out_k.objects.pos, out_p.objects.pos),
                       ("quat", out_k.objects.quat, out_p.objects.quat),
                       ("linvel", out_k.objects.linvel, out_p.objects.linvel),
                       ("angvel", out_k.objects.angvel, out_p.objects.angvel)):
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"solver kernel produced non-finite {name}")
        errs[name] = float((a - b).abs().max())
    bad = {k: v for k, v in errs.items() if not v <= SOLVER_TOL[k]}
    grasped = int(((out_p.gripper.finger_target == FINGER_CLOSED)
                   & (physics.gripper_width(out_p.gripper.q) > 0.005)).sum())
    k_in = solver_cuda.kernel_inputs(st, params)
    solver_ms = cuda_ms(lambda: solver_cuda.run_batch(*k_in, params=params, n_substeps=n_sub),
                        10, torch)
    solver_plain_ms = cuda_ms(lambda: physics.run(st, params, n_sub), 2, torch)
    K, S = st.objects.pos.shape[1], params.radii.shape[1]
    SC = params.oo_radii.shape[1]
    fl = solver_flops(B, K, S, SC, 5 if params.has_tray else 1, n_sub,
                      params.solver_iterations, params.pad_inner_iterations,
                      params.oo_pass_stride)
    io_bytes = 4 * B * (6 + 6 + 4 + 1 + K * (3 + 4 + 3 + 3 + 1 + S * 4 + SC * 4 + 1 + 3)
                        + 6 + 6 + K * (3 + 4 + 3 + 3))
    solver_bound = max(io_bytes / HBM_BYTES_PER_S, fl / FP32_FLOPS_PER_S) * 1e3
    log("solver", B=B, n_substeps=n_sub, max_abs_err=errs, tol=SOLVER_TOL,
        kernel_ms=solver_ms, plain_ms=solver_plain_ms, bound_ms=solver_bound,
        flops=fl, bytes=io_bytes, envs_closing=int(half.sum()), envs_holding=grasped)
    if bad:
        raise RuntimeError(f"solver kernel disagrees with physics.run: {bad}")

    # ---- 3. raster: kernel vs plain version (B=100, 64x64)
    rs = env.reset_env(gen, B, 1.0)
    rs = rs.replace(sim=out_p)
    cam_pos, cam_R = raycast.camera_pose_from_gripper(rs.sim.gripper.q, rs.cam_t, rs.cam_R)
    H, W = env.im_h, env.im_w
    args = (rs.sim, params, cam_pos, cam_R, rs.intrinsics, H, W, env.near, env.far)
    d_k, s_k = raster_cuda.render_batch(*args)
    d_p, s_p = raycast.render(*args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(d_k).all()) or d_k.shape != (B, H, W):
        raise RuntimeError("raster kernel produced a bad depth image")
    same = s_k == s_p
    mismatch = int((~same).sum())
    err = (d_k - d_p).abs()
    depth_err = float(err[same].max())
    n_over = int((err[same] > DEPTH_TOL).sum())
    worst = int(torch.argmax(torch.where(same, err, torch.zeros_like(err))))
    r_args, r_kw = raster_cuda.kernel_inputs(*args)
    raster_ms = cuda_ms(lambda: raster_cuda.raster_depth_seg(*r_args, **r_kw), 50, torch)
    raster_glue_ms = cuda_ms(lambda: raster_cuda.render_batch(*args), 20, torch)
    raster_plain_ms = cuda_ms(lambda: raycast.render(*args), 5, torch)
    P = K * S
    n_walls = 4 if params.has_tray else 0
    r_flops = B * H * W * (20 + 10 + P * 25 + 3 * 45 + n_walls * 35)
    r_bytes = 4 * B * (P * 5 + 9 + 9 + 3 + 9 + 4) + 8 * B * H * W
    raster_bound = max(r_bytes / HBM_BYTES_PER_S, r_flops / FP32_FLOPS_PER_S) * 1e3
    log("raster", B=B, H=H, W=W, P=P, depth_max_abs_err=depth_err,
        depth_px_over_tol=n_over, depth_tol=DEPTH_TOL, depth_edge_tol=DEPTH_EDGE_TOL,
        worst_px={"seg": int(s_p.reshape(-1)[worst]), "depth": float(d_p.reshape(-1)[worst])},
        seg_mismatch_px=mismatch, seg_mismatch_cap=int(SEG_MISMATCH_FRAC * B * H * W),
        object_px=int((s_p > 0).sum()), kernel_ms=raster_ms, plain_ms=raster_plain_ms,
        kernel_with_gather_ms=raster_glue_ms, bound_ms=raster_bound, flops=r_flops,
        bytes=r_bytes)
    if (not depth_err <= DEPTH_EDGE_TOL or n_over > DEPTH_OVER_FRAC * B * H * W
            or mismatch > SEG_MISMATCH_FRAC * B * H * W):
        raise RuntimeError("raster kernel disagrees with raycast.render")

    # ---- 4. policy: the r5c bundle through policy_io, card vs CPU
    _, actor, norm = train.load_bundle_actor(BUNDLE, dev)
    _, actor_cpu, _ = train.load_bundle_actor(BUNDLE, "cpu")
    obs = torch.zeros((1, H, W, 2))
    obs[..., 0] = torch.linspace(0.25, 0.45, H)[:, None]
    obs[0, 0, 0, 1] = 0.5
    with torch.no_grad():
        mean, log_std = actor(obs.to(dev))
        mean_c, log_std_c = actor_cpu(obs)
    a_err = max(float((mean.cpu() - mean_c).abs().max()),
                float((log_std.cpu() - log_std_c).abs().max()))
    log("policy", mean=mean[0].tolist(), log_std=log_std[0].tolist(), card_vs_cpu=a_err,
        tol=ACTOR_TOL)
    if not (bool(torch.isfinite(mean).all()) and a_err <= ACTOR_TOL):
        raise RuntimeError("actor output on the card disagrees with the CPU")

    # ---- 5. eval: `run --npz` through the entry point, launches counted
    solver_cuda.run_batch.launches = 0
    raster_cuda.raster_depth_seg.launches = 0
    res = train.main(["run", "--npz", BUNDLE, "--episodes", str(EPISODES)])
    launches = {"solver": solver_cuda.run_batch.launches,
                "raster": raster_cuda.raster_depth_seg.launches}
    sr = res["success_rate"]
    band = 2.0 * (0.86 * 0.14 / EPISODES) ** 0.5
    log("eval", episodes=res["episodes"], success_rate=sr, mean_return=res["mean_return"],
        mean_length=res["mean_length"], control_steps=res["control_steps"],
        wall_seconds=res["wall_seconds"], launches=launches,
        jax_reference_val=0.86, band_2sigma=[0.86 - band, 0.86 + band])
    if res["episodes"] != EPISODES or not 0.0 <= sr <= 1.0 or not np.isfinite(res["mean_return"]):
        raise RuntimeError(f"evaluation result is malformed: {res}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the path was not launched: {launches}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a",
          flush=True)
    kernels = [
        {"name": "solver_kernel", "route": "cuda",
         "source": "deep_rl_grasping_tpu_torch/csrc/solver.cu",
         "replaces": "deep_rl_grasping_tpu/ops/solver_pallas.py:107",
         "launches": launches["solver"], "max_abs_err": max(errs.values()),
         "ms": solver_ms, "plain_ms": solver_plain_ms, "bound_ms": solver_bound,
         "bound_by": "operations" if fl / FP32_FLOPS_PER_S > io_bytes / HBM_BYTES_PER_S
         else "bytes", "library_ms": None},
        {"name": "raster_kernel", "route": "cuda",
         "source": "deep_rl_grasping_tpu_torch/csrc/raster.cu",
         "replaces": "deep_rl_grasping_tpu/ops/raster_pallas.py:39",
         "launches": launches["raster"], "max_abs_err": depth_err,
         "ms": raster_ms, "plain_ms": raster_plain_ms, "bound_ms": raster_bound,
         "bound_by": "operations" if r_flops / FP32_FLOPS_PER_S > r_bytes / HBM_BYTES_PER_S
         else "bytes", "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
