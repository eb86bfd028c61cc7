#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `deep_rl_grasping_tpu_torch/csrc` with
plain nvcc, holds each kernel (the solver; the raster with depth + seg and
with its shade output) against its plain PyTorch version at the shapes of
both main paths (eval: B=100, the nominal camera; train: B=128, a randomized
camera pose and intrinsics per env), then drives the port's two paths through the
command-line entry point, each with the launch counts set to 0 just before
and read just after:

* eval: `run --npz trained/sac_full_flagship_r5c` (100 episodes,
  validation split) with the committed flagship SAC bundle;
* train: `train` on configs/sac_rgbd_flagship.yaml at full width (128
  envs, 128 updates of batch 256 per iteration, 64x64x5 observations, the
  250k + 100k replay), with only the frame counts and cadences cut
  (TRAIN_CUTS), into a temporary directory; then `run --model` on the
  checkpoint it wrote.

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
import tempfile
import time

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join("trained", "sac_full_flagship_r5c")
EPISODES = 100  # the evaluation protocol
TRAIN_CONFIG = os.path.join("configs", "sac_rgbd_flagship.yaml")
# The only cuts of the training run: frames and cadences, so that seeding,
# 128 updates per iteration from the first iteration, an eval, a
# checkpoint, save_best and a demo refresh each happen. Widths, batch,
# replay and demo capacities stay the config's.
TRAIN_CUTS = {("SAC", "total_timesteps"): 2048, ("tpu", "demo_frames"): 2048,
              ("SAC", "learning_starts"): 2048, ("tpu", "eval_freq"): 1024,
              ("tpu", "checkpoint_freq"): 1024, ("tpu", "demo_refresh_every"): 1024}

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
# Shade where the ids agree: to 1e-4 on all but 0.5% of pixels and to 2e-2
# on every pixel. The kernel derives a sphere's normal from the ray
# parameter, the plain version from the hit point; at a silhouette n.d -> 0
# and both are ill-conditioned, as the depth is there. Where two spheres of
# one object meet, the normal jumps across the crease and float rounding
# picks the nearer sphere, so the kernel's shade is held to that of any hit
# of its id within DEPTH_TOL of the nearest (raycast.shade_gap). The RGB the
# env gets must be exactly shade x id color of the kernel's outputs.
SHADE_TOL = 1e-4
SHADE_OVER_FRAC = 5e-3
SHADE_EDGE_TOL = 2e-2
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


def reset_counts(solver_cuda, raster_cuda):
    solver_cuda.run_batch.launches = 0
    raster_cuda.raster_depth_seg.launches = 0
    raster_cuda.raster_depth_seg.shade_launches = 0


def read_counts(solver_cuda, raster_cuda):
    return {"solver": solver_cuda.run_batch.launches,
            "raster": raster_cuda.raster_depth_seg.launches,
            "raster_shade": raster_cuda.raster_depth_seg.shade_launches}


def kernel_checks(path, env, B):
    """Solver, raster (depth + seg) and raster-with-shade kernels against
    their plain versions on one path's states (B envs of `env`, on the
    card); logs one line per kernel and raises on a disagreement. Returns
    the errors, times and bounds."""
    import torch

    from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda
    from deep_rl_grasping_tpu_torch.render import raycast
    from deep_rl_grasping_tpu_torch.sim import physics
    from deep_rl_grasping_tpu_torch.sim.types import FINGER_CLOSED

    dev = env.device
    params, n_sub = env.sim_params, env.gripper_substeps
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
            raise RuntimeError(f"solver kernel produced non-finite {name} ({path} shapes)")
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
    log("solver", path=path, B=B, n_substeps=n_sub, max_abs_err=errs, tol=SOLVER_TOL,
        kernel_ms=solver_ms, plain_ms=solver_plain_ms,
        bound_ms=max(io_bytes / HBM_BYTES_PER_S, fl / FP32_FLOPS_PER_S) * 1e3,
        flops=fl, bytes=io_bytes, envs_closing=int(half.sum()), envs_holding=grasped)
    if bad:
        raise RuntimeError(f"solver kernel disagrees with physics.run ({path} shapes): {bad}")

    rs = env.reset_env(gen, B, 1.0)
    q = out_p.gripper.q.clone()
    q[:, 3] = torch.linspace(-3.1, 3.1, B, device=dev)
    rs = rs.replace(sim=out_p.replace(gripper=out_p.gripper.replace(q=q)))
    cam_pos, cam_R = raycast.camera_pose_from_gripper(rs.sim.gripper.q, rs.cam_t, rs.cam_R)
    # per-env camera spread: 0 for the nominal camera, > 0 when randomized
    spread = {"intrinsics": float((rs.intrinsics - rs.intrinsics[:1]).abs().max()),
              "cam_R": float((rs.cam_R - rs.cam_R[:1]).abs().max())}
    H, W = env.im_h, env.im_w
    args = (rs.sim, params, cam_pos, cam_R, rs.intrinsics, H, W, env.near, env.far)
    d_k, s_k = raster_cuda.render_batch(*args)
    d_p, s_p = raycast.render(*args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(d_k).all()) or d_k.shape != (B, H, W):
        raise RuntimeError(f"raster kernel produced a bad depth image ({path} shapes)")
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
    log("raster", path=path, B=B, H=H, W=W, P=P, camera_spread=spread,
        depth_max_abs_err=depth_err, depth_px_over_tol=n_over, depth_tol=DEPTH_TOL,
        depth_edge_tol=DEPTH_EDGE_TOL,
        worst_px={"seg": int(s_p.reshape(-1)[worst]), "depth": float(d_p.reshape(-1)[worst])},
        seg_mismatch_px=mismatch, seg_mismatch_cap=int(SEG_MISMATCH_FRAC * B * H * W),
        object_px=int((s_p > 0).sum()), kernel_ms=raster_ms, plain_ms=raster_plain_ms,
        kernel_with_gather_ms=raster_glue_ms,
        bound_ms=max(r_bytes / HBM_BYTES_PER_S, r_flops / FP32_FLOPS_PER_S) * 1e3,
        flops=r_flops, bytes=r_bytes)
    if (not depth_err <= DEPTH_EDGE_TOL or n_over > DEPTH_OVER_FRAC * B * H * W
            or mismatch > SEG_MISMATCH_FRAC * B * H * W):
        raise RuntimeError(f"raster kernel disagrees with raycast.render ({path} shapes)")

    # the shade output (RGB-D observations) on the same scenes, and the RGB
    # image the env assembles from it
    d_ks, s_ks, sh_k = raster_cuda.raster_depth_seg(*r_args, **r_kw, with_shade=True)
    _, _, sh_p = raycast.render_shade(*args)
    gap = raycast.shade_gap(s_ks, sh_k, raycast.hit_candidates(*args[:7], env.near), DEPTH_TOL)
    rgb_k, _, _ = raster_cuda.render_batch(*args, with_rgb=True)
    rgb_p, _, _ = raycast.render(*args, with_rgb=True)
    lut = raycast.color_lut(params, rs.sim.objects.obj_type)
    torch.cuda.synchronize()
    same_launch = bool(torch.equal(d_ks, d_k) and torch.equal(s_ks, s_k))
    rgb_assembled = bool(torch.equal(rgb_k, raycast.shade_to_rgb(s_ks, sh_k, lut)))
    gap = gap[same]
    shade_err = float(gap.max())
    shade_over = int((gap > SHADE_TOL).sum())
    direct = (sh_k - sh_p).abs()[same]
    crease_px = int((direct > gap).sum())
    shade_ms = cuda_ms(lambda: raster_cuda.raster_depth_seg(*r_args, **r_kw, with_shade=True),
                       50, torch)
    shade_plain_ms = cuda_ms(lambda: raycast.render_shade(*args), 5, torch)
    # the shade adds, per pixel, the winner's normal and Lambert term (~30
    # operations) and a select per candidate; per pixel 4 more output bytes
    s_flops = r_flops + B * H * W * (30 + P + 3 + n_walls)
    s_bytes = r_bytes + 4 * B * H * W
    log("raster_shade", path=path, B=B, H=H, W=W, depth_seg_equal_to_plain_launch=same_launch,
        shade_max_abs_err=shade_err, shade_px_over_tol=shade_over,
        shade_max_abs_err_to_plain_winner=float(direct.max()), crease_px=crease_px,
        rgb_equal_to_assembled_shade=rgb_assembled,
        rgb_max_abs_err_to_plain=float((rgb_k - rgb_p).abs()[same].max()),
        shade_tol=SHADE_TOL, shade_edge_tol=SHADE_EDGE_TOL, tie_tol=DEPTH_TOL,
        lit_px=int((sh_k > 0.35).sum()), kernel_ms=shade_ms, plain_ms=shade_plain_ms,
        bound_ms=max(s_bytes / HBM_BYTES_PER_S, s_flops / FP32_FLOPS_PER_S) * 1e3,
        flops=s_flops, bytes=s_bytes)
    if (not same_launch or not rgb_assembled or not bool(torch.isfinite(sh_k).all())
            or not shade_err <= SHADE_EDGE_TOL or shade_over > SHADE_OVER_FRAC * B * H * W):
        raise RuntimeError("raster kernel's shade output disagrees with raycast.render_shade "
                           f"({path} shapes)")
    return dict(solver_err=max(errs.values()), depth_err=depth_err, shade_err=shade_err,
                solver=(solver_ms, solver_plain_ms, fl, io_bytes),
                raster=(raster_ms, raster_plain_ms, r_flops, r_bytes),
                shade=(shade_ms, shade_plain_ms, s_flops, s_bytes))


def kernel_entry(name, source, replaces, launches, launches_by_path, max_abs_err, timing):
    """One entry of the `kernels` line from (ms, plain ms, operations, bytes)."""
    ms, plain_ms, flops, nbytes = timing
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": launches_by_path,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes", "library_ms": None}


def main():
    import logging

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from deep_rl_grasping_tpu_torch.envs.grasp_env import GraspEnv
        from deep_rl_grasping_tpu_torch.ops import build, raster_cuda, solver_cuda
        from deep_rl_grasping_tpu_torch.training import train
        from deep_rl_grasping_tpu_torch.utils import config as cfg_util
        from deep_rl_grasping_tpu_torch.utils import io_utils
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 1
    os.chdir(REPO)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    dev = torch.device("cuda")
    train.set_precision()
    kind = torch.cuda.get_device_name(0)
    log("start", device=kind, torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 1. build
    lib = build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "stack frame" in ln]
    log("build", seconds=round(lib.build_seconds, 3), reused=lib.reused, ptxas=ptxas)

    # ---- 2-3. kernels vs plain versions, at the shapes of both paths: eval
    # (the bundle's config, B=100, the nominal camera) and train (the RGB-D
    # flagship, B=num_envs=128, a randomized camera pose and intrinsics per
    # env). Per path: the solver on reset states with half the batch
    # closing on an object; the raster (depth + seg, then with shade) on the
    # stepped states with the grippers yawed over the whole circle (the
    # camera and the finger pads turn with them).
    config = cfg_util.load_config(os.path.join(BUNDLE, "config.yaml"))
    env = GraspEnv(config, evaluate=True, validate=True, device=dev)
    train_env = GraspEnv(cfg_util.load_config(TRAIN_CONFIG), device=dev)
    if train_env.randomize is None or not train_env.full_obs:
        raise RuntimeError(f"{TRAIN_CONFIG} should randomize the camera and observe RGB-D")
    H, W = env.im_h, env.im_w
    checks = {}
    for path, penv, B in (("eval", env, EPISODES),
                          ("train", train_env, int(train_env.config["tpu"]["num_envs"]))):
        checks[path] = kernel_checks(path, penv, B)
    solver_err = max(c["solver_err"] for c in checks.values())
    depth_err = max(c["depth_err"] for c in checks.values())
    shade_err = max(c["shade_err"] for c in checks.values())

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
    reset_counts(solver_cuda, raster_cuda)
    res = train.main(["run", "--npz", BUNDLE, "--episodes", str(EPISODES)])
    launches = read_counts(solver_cuda, raster_cuda)
    sr = res["success_rate"]
    band = 2.0 * (0.86 * 0.14 / EPISODES) ** 0.5
    log("eval", episodes=res["episodes"], success_rate=sr, mean_return=res["mean_return"],
        mean_length=res["mean_length"], control_steps=res["control_steps"],
        wall_seconds=res["wall_seconds"], launches=launches,
        jax_reference_val=0.86, band_2sigma=[0.86 - band, 0.86 + band])
    if res["episodes"] != EPISODES or not 0.0 <= sr <= 1.0 or not np.isfinite(res["mean_return"]):
        raise RuntimeError(f"evaluation result is malformed: {res}")
    if min(launches["solver"], launches["raster"]) <= 0:
        raise RuntimeError(f"a kernel of the eval path was not launched: {launches}")

    # ---- 6. train: `train` on the RGB-D flagship at full width, launches counted
    cfg = cfg_util.load_config(TRAIN_CONFIG)
    tpu, sac_cfg = cfg["tpu"], cfg["SAC"]
    # the demo ring keeps the capacity the uncut config gives it
    tpu.setdefault("demo_capacity", tpu["demo_frames"])
    for (block, key), value in TRAIN_CUTS.items():
        cfg[block][key] = value
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        cfg_path = os.path.join(tmp, "config.yaml")
        io_utils.save_yaml(cfg, cfg_path)
        model_dir = os.path.join(tmp, "run")
        log("train_start", config=TRAIN_CONFIG,
            cuts={f"{b}.{k}": v for (b, k), v in TRAIN_CUTS.items()},
            num_envs=tpu["num_envs"], updates_per_step=tpu["updates_per_step"],
            batch_size=sac_cfg["batch_size"], demo_fraction=tpu["demo_fraction"],
            buffer_size=sac_cfg["buffer_size"], demo_capacity=tpu["demo_capacity"],
            layers=sac_cfg["layers"])
        torch.cuda.reset_peak_memory_stats()
        reset_counts(solver_cuda, raster_cuda)
        tr = train.main(["train", "--config", cfg_path, "--algo", "SAC", "--model_dir",
                         model_dir, "--seed", "0"])
        train_launches = read_counts(solver_cuda, raster_cuda)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        (env_s, n_iter), (upd_s, n_upd_iter) = tr["phase_seconds"]["env"], \
            tr["phase_seconds"]["update"]
        n_updates = tr["updates"]
        losses = {k: tr["metrics"].get(k) for k in ("critic_loss", "actor_loss", "bc_loss",
                                                    "alpha_loss", "q_target_mean", "entropy")}
        log("train", frames=tr["frames"], done=tr["done"], wall_seconds=tr["wall_seconds"],
            iterations=n_iter, updates=n_updates,
            env_frames_per_s_of_the_step=tpu["num_envs"] / (env_s / n_iter),
            iteration_frames_per_s=n_iter * tpu["num_envs"] / (env_s + upd_s),
            end_to_end_frames_per_s=tr["frames"] / tr["wall_seconds"],
            ms_per_env_step=env_s / n_iter * 1e3,
            ms_per_sac_update=upd_s / max(n_updates, 1) * 1e3,
            ms_updates_per_iteration=upd_s / max(n_upd_iter, 1) * 1e3,
            curriculum_lambda=tr["curriculum_lambda"], success_rate=tr["success_rate"],
            episodes=tr["episodes"], losses=losses, eval=tr["eval"],
            max_memory_allocated_gib=peak_gib, launches=train_launches,
            checkpoint_step=tr["checkpoint_step"])
        if (not tr["done"] or tr["frames"] != TRAIN_CUTS[("SAC", "total_timesteps")]
                or n_updates != n_iter * tpu["updates_per_step"]
                or not all(v is not None and np.isfinite(v) for v in losses.values())):
            raise RuntimeError(f"training run is malformed: {tr}")
        if min(train_launches["solver"], train_launches["raster_shade"]) <= 0:
            raise RuntimeError(f"a kernel of the train path was not launched: {train_launches}")

        # ---- 7. `run --model` on the checkpoint the training run wrote
        reset_counts(solver_cuda, raster_cuda)
        ev = train.main(["run", "--model", model_dir, "--episodes", str(EPISODES)])
        log("run_model", episodes=ev["episodes"], success_rate=ev["success_rate"],
            mean_return=ev["mean_return"], wall_seconds=ev["wall_seconds"],
            launches=read_counts(solver_cuda, raster_cuda))
        if ev["episodes"] != EPISODES or not np.isfinite(ev["mean_return"]):
            raise RuntimeError(f"run --model result is malformed: {ev}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a",
          flush=True)
    # times and bounds at the shapes of the path each kernel's launches come
    # from: the solver and the shade launch at the train path's (B=128),
    # the depth + seg launch at the eval path's (B=100)
    src = "deep_rl_grasping_tpu_torch/csrc/"
    by_path = lambda key: {"eval": launches[key], "train": train_launches[key]}
    kernels = [
        kernel_entry("solver_kernel", src + "solver.cu",
                     "deep_rl_grasping_tpu/ops/solver_pallas.py:107", train_launches["solver"],
                     by_path("solver"), solver_err, checks["train"]["solver"]),
        kernel_entry("raster_kernel", src + "raster.cu",
                     "deep_rl_grasping_tpu/ops/raster_pallas.py:39", launches["raster"],
                     by_path("raster"), depth_err, checks["eval"]["raster"]),
        kernel_entry("raster_kernel_shade", src + "raster.cu",
                     "deep_rl_grasping_tpu/ops/raster_pallas.py:39 (with_shade, :204-205)",
                     train_launches["raster_shade"], by_path("raster_shade"), shade_err,
                     checks["train"]["shade"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
