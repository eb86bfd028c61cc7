#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `deep_rl_grasping_tpu_torch/csrc` with
plain nvcc (one nvcc per source, in parallel), reports the solver kernel's
resources (registers, local bytes, shared bytes per env), holds each kernel
(the solver; the raster with depth + seg and with its shade output) against
its plain PyTorch version at the shapes of both main paths (eval: B=100,
the nominal camera; train: B=128, a randomized camera pose and intrinsics
per env; the solver on the scenes of two seeds and at two horizons, see
SOLVER_SEEDS; the raster's per-tile culled launch also against a launch
with every live sphere in every tile's list and against a repeat of
itself, bit for bit, and the tile lists the kernel writes against the
plain twin of its cull), times each kernel on the device (`device_ms`: 50
launches captured in one CUDA graph, replayed between CUDA events; the
ms per Python call beside it as `call_ms`), then drives the port's two paths
through the command-line entry point, each with the launch counts set to 0
just before and read just after:

* eval: `run --npz trained/sac_full_flagship_r5c` (100 episodes,
  validation split) with the committed flagship SAC bundle; then, as a
  check, the same bundle twice from the JAX package's own 100 validation
  scenes (`deep_rl_grasping_tpu_torch/data/r5c_val_scenes.npz`), which
  must give the same result both times (the kernels are deterministic);
* train: `train` on configs/sac_rgbd_flagship.yaml at full width (128
  envs, 128 updates of batch 256 per iteration, 64x64x5 observations, the
  250k + 100k replay), with only the frame counts and cadences cut
  (TRAIN_CUTS), into a temporary directory; then `run --model` on the
  checkpoint it wrote;
* encoder latents: first the trained encoder (encoder_files/full_r4) on
  the card against the same module on the CPU, on masked depth images the
  raster kernel renders at B=100, and the latents of the kernel's render
  against those of the plain render (`encoder`); then `run --npz
  trained/sac_encoder_flagship_r5` and the same bundle twice from the JAX
  package's validation scenes (`eval_encoder`); then `train` on
  configs/sac_encoder_flagship.yaml at full width (128 envs, 128 updates
  of batch 256, 101-wide latents, the 1M + 100k replay), cut as TRAIN_CUTS
  cuts the RGB-D run, and `run --model` on its checkpoint
  (`train_encoder_latent`, `run_model_encoder_latent`);
* the simplified task with the discrete learners: first the solver kernel
  on the simplified step's three calls (the move for 8 substeps, the grasp
  attempt for 16 with the fingers of half the batch closing, the 5 cm lift
  for 16), each input made through the kernel as the main path makes it,
  at B=100 and B=128 (`solver_check` lines with `call`, then
  `solver_simplified`); then `run --npz trained/bdq_simplified_r5` and
  `run --npz trained/dqn_simplified_r5` and each bundle twice from the JAX
  package's validation scenes of these bundles
  (`deep_rl_grasping_tpu_torch/data/simplified_r5_val_scenes.npz`;
  `eval_bdq`, `eval_dqn`); then `train` on configs/bdq_simplified.yaml and
  configs/dqn_simplified.yaml at full width (128 envs, 64 prioritized
  updates of batch 64 per iteration, the 1M-row ring of 100-wide latents),
  cut as TRAIN_CUTS cuts the SAC runs, and `run --model` on each
  checkpoint (`train_bdq`, `run_model_bdq`, `train_dqn`, `run_model_dqn`);
* resume: the BDQ run resumed with `train --load_dir` for another
  TRAIN_CUTS frames at the same width. First a fresh trainer takes the
  checkpoint and the ring snapshot through the functions `train` restores
  them with, and must hold the saved learner state (params, targets, Adam
  state, update count) and the newest min(size, 65536) ring rows with their
  priorities, the seam's rows done; then the resumed run goes through the
  entry point, launches counted (`resume`); then `tools/export_policy`
  writes a bundle of its checkpoint, and `run --npz` of the bundle and
  `run --model` of the checkpoint, both from the JAX package's validation
  scenes, must give the same success rate and the same first-step greedy
  actions (`export`, `run_npz_vs_model`);
* the continuous simplified task with DDPG, PPO and TRPO: `train` on
  configs/ddpg_simplified.yaml at full width (128 envs, 64 uniform updates
  of batch 64 per iteration, the 500k ring, demo seeding), cut as
  TRAIN_CUTS cuts the other replay runs, and on configs/ppo_simplified.yaml
  and trpo_simplified.yaml at full width (128 envs x 64 steps = 8192
  frames per policy iteration, [256, 256] towers), cut to two policy
  iterations (ONPOLICY_CUTS); `run --model` on each checkpoint
  (`train_ddpg`, `run_model_ddpg`, `train_ppo`, `run_model_ppo`,
  `train_trpo`, `run_model_trpo`); the PPO checkpoint is exported and
  `run --npz` of the bundle held to `run --model` as in the resume phase
  (`export_ppo`, `run_npz_vs_model_ppo`). Each training line gives
  frames/s, ms per control step of the env (the on-policy rollout's),
  ms per update (a PPO minibatch step, or TRPO's whole update: gradient,
  conjugate gradient, line search, value fit) and per iteration's
  updates, peak GiB and the launches;
* table clearing on the OnTable tray: first each kernel against its plain
  version on the clearing path's states (eval: the clearing bundle's
  config, B=100; train: configs/sac_table_clearing.yaml, B=128, randomized
  cameras), on scenes where every env's highest object was just removed
  (dead, still in place) and on the plain reset scenes (`solver_check`,
  `raster` lines with path `*_clearing*`), and the removal check
  (`removal`: the kernel render of the post-removal states shows no pixel
  of a dead object that would be in view if it were alive); then `run --npz
  trained/sac_table_clearing_v2` (100 episodes, 200 control steps) and the
  bundle twice from the JAX package's validation scenes of it
  (`eval_clearing`: success rate, mean and per-episode objects cleared);
  `trained/sac_full_flagship_r5b` twice from its JAX validation scenes
  (`eval_r5b`); the scripted expert on the clearing task at lambda 0 and 1,
  128 episodes each (`expert_clearing`); `train` on
  configs/sac_table_clearing.yaml at full width (128 envs, 128 updates of
  batch 256, the 500k ring, demo seeding), cut by TRAIN_CUTS, and `run
  --model` on its checkpoint (`train_clearing`, `run_model_clearing`);
* the folded update: `train` on configs/sac_simplified_batched_quality.yaml
  at full width (256 envs, update_batch_scale 8: 4 updates of batch 1024
  per iteration, the full_r4 encoder's latents), cut by TRAIN_CUTS, and
  `run --model` (`train_batched`, `run_model_batched`; ms per folded
  update);
* encoder training: `collect_dataset` of 2048 + 256 masked depth images
  from configs/sac_full_flagship.yaml (`--keep_task --mix_lambda`, 128
  envs; `collect_encoder`), `train_encoder train` of the full-width
  autoencoder (32-32-32 filters, 100 latents, batch 128) for AE_EPOCHS
  epochs and `test` (`train_ae`), then the trained encoder loaded through
  the trainer's `_maybe_load_encoder` and one latent env step of
  configs/sac_encoder_flagship.yaml with it (`ae_latent_step`).

Each phase prints one JSON line with its elapsed seconds. The last three
lines are the card's name and power limit (nvidia-smi), one JSON object
with every kernel's measurements (the raster's `bound_ms` counts the
pixel-sphere pairs its culled launch tests, from the lists it writes;
`bound_ms_all_pairs` counts every pair, as the first design's bound
did), and the result line `{"ok": true, "device": {...}}`. Any failure
raises and the exit code is non-zero; without a CUDA device it exits
non-zero and prints no result.

Imports only the standard library, numpy, torch and the port.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join("trained", "sac_full_flagship_r5c")
# The JAX package's own 100 validation scenes of that bundle (its
# PRNGKey(1) reset at lambda 1), saved as env states under `scene.*`;
# built by tests/test_torch_eval_scenes.py.
SCENES = os.path.join("deep_rl_grasping_tpu_torch", "data", "r5c_val_scenes.npz")
EPISODES = 100  # the evaluation protocol
TRAIN_CONFIG = os.path.join("configs", "sac_rgbd_flagship.yaml")
# The encoder-latent bundle. Its config differs from the r5c bundle's in no
# scene, curriculum, camera or simulation key, and the JAX package's
# validation scenes of it are the arrays of SCENES (tests/
# test_torch_eval_scenes.py --compare trained/sac_encoder_flagship_r5).
ENCODER_BUNDLE = os.path.join("trained", "sac_encoder_flagship_r5")
ENCODER_TRAIN_CONFIG = os.path.join("configs", "sac_encoder_flagship.yaml")
# The simplified-task bundles (encoder latents, prioritized replay): BDQ
# with 8 bins per branch, DQN with Discrete(3 x 4). Their configs differ
# only in the algorithm block, and the JAX package's validation scenes of
# both are the arrays of SIMP_SCENES (tests/test_torch_eval_scenes.py
# --compare trained/dqn_simplified_r5).
BDQ_BUNDLE = os.path.join("trained", "bdq_simplified_r5")
DQN_BUNDLE = os.path.join("trained", "dqn_simplified_r5")
SIMP_SCENES = os.path.join("deep_rl_grasping_tpu_torch", "data", "simplified_r5_val_scenes.npz")
BDQ_TRAIN_CONFIG = os.path.join("configs", "bdq_simplified.yaml")
DQN_TRAIN_CONFIG = os.path.join("configs", "dqn_simplified.yaml")
# JAX validation success rates of the bundles (their PROVENANCE.md)
JAX_VAL = {BUNDLE: 0.86, ENCODER_BUNDLE: 0.42, BDQ_BUNDLE: 0.68, DQN_BUNDLE: 0.60}
# The only cuts of the training run: frames and cadences, so that seeding,
# all updates per iteration from the first iteration, an eval, a
# checkpoint, save_best and a demo refresh each happen. Widths, batch,
# replay and demo capacities stay the config's. "ALGO" is the algorithm's
# own block (SAC, DQN, BDQ); cutting its total_timesteps also shortens the
# DQN / BDQ epsilon anneal, which spans exploration_fraction of it.
TRAIN_CUTS = {("ALGO", "total_timesteps"): 2048, ("tpu", "demo_frames"): 2048,
              ("ALGO", "learning_starts"): 2048, ("tpu", "eval_freq"): 1024,
              ("tpu", "checkpoint_freq"): 1024, ("tpu", "demo_refresh_every"): 1024}
# PPO and TRPO: one policy iteration is n_steps x num_envs = 8192 frames
# on their configs, so the runs are cut to two iterations (an eval, a
# checkpoint and save_best after each); nothing else is cut.
ON_POLICY = ("PPO", "TRPO")
ONPOLICY_CUTS = {("ALGO", "total_timesteps"): 16384, ("tpu", "eval_freq"): 8192,
                 ("tpu", "checkpoint_freq"): 8192}
DDPG_TRAIN_CONFIG = os.path.join("configs", "ddpg_simplified.yaml")
PPO_TRAIN_CONFIG = os.path.join("configs", "ppo_simplified.yaml")
TRPO_TRAIN_CONFIG = os.path.join("configs", "trpo_simplified.yaml")
# Table clearing: the one clearing bundle (JAX CLI on the CPU, `run --npz
# trained/sac_table_clearing_v2`: success 0.00, objects cleared 0.00 of
# 100 episodes) and the JAX package's validation scenes of it; its
# training config.
CLEARING_BUNDLE = os.path.join("trained", "sac_table_clearing_v2")
CLEARING_SCENES = os.path.join("deep_rl_grasping_tpu_torch", "data", "clearing_v2_val_scenes.npz")
CLEARING_TRAIN_CONFIG = os.path.join("configs", "sac_table_clearing.yaml")
JAX_CLEARING = {"success_rate": 0.0, "mean_cleared": 0.0}
# The one bundle on the default object-object solver options, gated on its
# own JAX validation scenes (0.84 val at export; the 2-sigma band).
R5B_BUNDLE = os.path.join("trained", "sac_full_flagship_r5b")
R5B_SCENES = os.path.join("deep_rl_grasping_tpu_torch", "data", "r5b_val_scenes.npz")
R5B_BAND = (0.77, 0.91)
EXPERT_EPISODES = 128
# The JAX package's expert under the same protocol on the CPU, 128
# episodes per lambda, one JSON line per lambda with the per-episode values
# (`JAX_PLATFORMS=cpu python tests/test_torch_clearing.py > <this file>`)
JAX_EXPERT_CLEARING = os.path.join("deep_rl_grasping_tpu_torch", "data",
                                   "jax_expert_clearing.jsonl")
BATCHED_TRAIN_CONFIG = os.path.join("configs", "sac_simplified_batched_quality.yaml")
# Encoder training: the full-task collect of encoder_files/full_r4's
# recipe, cut to AE_IMAGES images and AE_EPOCHS epochs.
AE_COLLECT_CONFIG = os.path.join("configs", "sac_full_flagship.yaml")
AE_IMAGES = (2048, 256)
AE_EPOCHS = 3
# the losses each learner's training run must log as finite numbers
LOSS_KEYS = {"SAC": ("critic_loss", "actor_loss", "bc_loss", "alpha_loss", "q_target_mean",
                     "entropy"),
             "DQN": ("loss", "td_abs"), "BDQ": ("loss", "td_abs"),
             "DDPG": ("critic_loss", "actor_loss"),
             "PPO": ("loss", "pg_loss", "vf_loss", "entropy"),
             "TRPO": ("surrogate", "kl", "vf_loss", "line_search_ok")}

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
SOLVER_OUTPUTS = (("q", "gripper", "q"), ("qd", "gripper", "qd"), ("pos", "objects", "pos"),
                  ("quat", "objects", "quat"), ("linvel", "objects", "linvel"),
                  ("angvel", "objects", "angvel"))
# The solver is checked on the scenes of two seeds per path, settled as the
# main path settles them (through the kernel), at two horizons. A scene may
# hold an object tumbling in contact, where the contact solve is
# ill-conditioned: there float32 rounding alone moves the plain version's
# result by ~1e-4 of itself in one substep (against a float64 run of it),
# the kernel's rounding by about as much, and over 16 substeps the two
# trajectories may take different branches (PERF.md: on 7 of 16 seeds the
# parent's kernel too left SOLVER_TOL in such envs, and so does the plain
# version itself under one-ulp input perturbations in some of them). So
# every env is held to SOLVER_TOL after SHORT_SUBSTEPS substeps (every
# category, the warm start, before branches part), and after the main
# path's n_substeps every env but at most DIVERGING_ENV_FRAC of them.
SOLVER_SEEDS = (0, 1)
SHORT_SUBSTEPS = 4
DIVERGING_ENV_FRAC = 0.05
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
# Encoder on the card vs the same weights on the CPU, same masked images:
# three bf16 convolutions and a 2048-wide bf16 dense layer that round at
# other places in cuDNN/cuBLAS and in the CPU kernels (the port against the
# JAX package on the CPU: one bf16 ulp, 0.0078, at latents up to ~1.6).
ENCODER_TOL = 5e-2


def log(phase, **kv):
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - T0, 3), **kv}),
          flush=True)


def cuda_ms(fn, reps, torch):
    """Mean milliseconds per call of fn() on the current stream (CUDA events
    around `reps` calls from Python): where the host needs longer per call
    than the device, this is the host's pace (`call_ms`)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


DEVICE_REPS = 50  # launches per CUDA graph in device_ms
TIMING = "cuda_graph"  # how the `ms` of the kernels line is measured: device_ms


def device_ms(fn, torch, reps=DEVICE_REPS):
    """Mean device milliseconds per launch of fn(): `reps` calls captured in
    one CUDA graph (their outputs come from the graph's private pool), the
    graph replayed once to warm up and once more between CUDA events, so
    the host's per-call work is not in the figure. The wrappers' launch
    counts are restored after the capture: a capture enqueues nothing."""
    from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda

    fn()
    torch.cuda.synchronize()
    counts = read_counts(solver_cuda, raster_cuda)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    set_counts(solver_cuda, raster_cuda, counts)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def set_counts(solver_cuda, raster_cuda, counts):
    solver_cuda.run_batch.launches = counts["solver"]
    raster_cuda.raster_depth_seg.launches = counts["raster"]
    raster_cuda.raster_depth_seg.shade_launches = counts["raster_shade"]


def reset_counts(solver_cuda, raster_cuda):
    set_counts(solver_cuda, raster_cuda, {"solver": 0, "raster": 0, "raster_shade": 0})


def read_counts(solver_cuda, raster_cuda):
    return {"solver": solver_cuda.run_batch.launches,
            "raster": raster_cuda.raster_depth_seg.launches,
            "raster_shade": raster_cuda.raster_depth_seg.shade_launches}


def solver_gaps(a, b):
    """Per env, the largest |a - b| of each solver output: {name: (B,)}."""
    out = {}
    for name, part, field in SOLVER_OUTPUTS:
        d = (getattr(getattr(a, part), field) - getattr(getattr(b, part), field)).abs()
        out[name] = d.reshape(d.shape[0], -1).amax(-1)
    return out


def _close_half(st, slot):
    """The second half of the batch descends onto object `slot` (B,) and
    closes the fingers, so the pad rows (the stiff squeeze) are exercised
    as well as the statics."""
    import torch

    from deep_rl_grasping_tpu_torch.sim.types import FINGER_CLOSED

    B, dev = st.gripper.q.shape[0], st.gripper.q.device
    half = torch.arange(B, device=dev) >= B // 2
    q = st.gripper.q.clone()
    pos = st.objects.pos[torch.arange(B, device=dev), slot]
    q[half, 0:2] = pos[half, 0:2]
    q[half, 2] = 0.07
    g = st.gripper.replace(
        q=q, target=q[:, :4].clone(),
        finger_target=torch.where(half, FINGER_CLOSED, st.gripper.finger_target))
    return st.replace(gripper=g)


def solver_check_scenes(env, B, seed):
    """B scenes of `env` drawn from `seed` and settled through the solver
    kernel, as the main path settles them; the second half of the batch
    then descends onto object slot 0 and closes the fingers. Returns the
    sim state and the generator, to draw on from."""
    import torch

    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = env.reset_env(gen, B, 1.0, settle_substeps=48).sim
    return _close_half(st, torch.zeros(B, dtype=torch.long, device=dev)), gen


def clearing_scenes(env, B, seed):
    """Table-clearing scenes: as `solver_check_scenes`, but every even env
    has just had its highest object removed as a clear removes it (dead,
    left where it was, so still in view), and the closing half descends
    onto its first alive object."""
    import torch

    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = env.reset_env(gen, B, 1.0, settle_substeps=48).sim
    removed = env._remove_highest(st)
    even = torch.arange(B, device=dev) % 2 == 0
    st = st.replace(objects=st.objects.replace(
        alive=torch.where(even[:, None], removed.objects.alive, st.objects.alive)))
    return _close_half(st, torch.argmax(st.objects.alive.to(torch.int32), -1)), gen


def removal_check(path, env, B):
    """The raster kernel on B states of `env` just after every env's highest
    object was removed: no pixel carries a removed object's id, though
    objects would be seen there alive (their pixels counted with the
    removed objects alive again, same grippers), and the kernel render
    agrees with the plain one by the raster check's rules. Logs `removal`;
    raises on a failure."""
    import torch

    from deep_rl_grasping_tpu_torch.ops import raster_cuda
    from deep_rl_grasping_tpu_torch.render import raycast

    dev = env.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    st = env.reset_env(gen, B, 1.0, settle_substeps=48)
    dead = env._remove_highest(st.sim)
    removed = st.sim.objects.alive & ~dead.objects.alive
    if not bool(removed.sum(-1).eq(1).all()):
        raise RuntimeError(f"removal check ({path}): not one object removed per env")
    rid = (3 + torch.argmax(removed.to(torch.int32), -1))[:, None, None]
    cam_pos, cam_R = raycast.camera_pose_from_gripper(dead.gripper.q, st.cam_t, st.cam_R)
    args = lambda sim: (sim, env.sim_params, cam_pos, cam_R, st.intrinsics, env.im_h, env.im_w,
                        env.near, env.far)
    d_k, s_k = raster_cuda.render_batch(*args(dead))
    d_p, s_p = raycast.render(*args(dead))
    _, s_alive = raster_cuda.render_batch(*args(dead.replace(
        objects=dead.objects.replace(alive=st.sim.objects.alive))))
    px_if_alive = (s_alive == rid).sum((1, 2))
    px_dead = int((s_k == rid).sum())
    same = s_k == s_p
    mismatch = int((~same).sum())
    depth_err = float((d_k - d_p).abs()[same].max())
    log("removal", path=path, B=B, envs_with_removed_in_view=int((px_if_alive > 0).sum()),
        removed_px_if_alive=int(px_if_alive.sum()), removed_px=px_dead,
        seg_mismatch_px=mismatch, seg_mismatch_cap=int(SEG_MISMATCH_FRAC * B * env.im_h * env.im_w),
        depth_max_abs_err=depth_err, depth_edge_tol=DEPTH_EDGE_TOL)
    if (px_dead or not int((px_if_alive > 0).sum()) or depth_err > DEPTH_EDGE_TOL
            or mismatch > SEG_MISMATCH_FRAC * B * env.im_h * env.im_w):
        raise RuntimeError(f"raster kernel after a removal ({path}): {px_dead} removed-object "
                           f"pixels, {mismatch} seg mismatches, depth error {depth_err}")


def solver_check(path, env, B, seed, scenes=solver_check_scenes, n_sub=None, call=None):
    """The solver kernel against its plain version on the scenes of
    `scenes(env, B, seed)` (default `solver_check_scenes`): every env within
    SOLVER_TOL after SHORT_SUBSTEPS substeps, and after the main path's
    n_substeps (default the env's gripper_substeps) all but at most
    DIVERGING_ENV_FRAC of them (see SOLVER_SEEDS). Logs one line, marked
    with `call` for a call of the simplified step; raises on a
    disagreement. Returns the states, the plain version's result at
    n_substeps, the generator (to draw on from) and the largest gap of each
    output at n_substeps."""
    import torch

    from deep_rl_grasping_tpu_torch.ops import solver_cuda
    from deep_rl_grasping_tpu_torch.sim import physics
    from deep_rl_grasping_tpu_torch.sim.types import FINGER_CLOSED

    dev = env.device
    params = env.sim_params
    n_sub = env.gripper_substeps if n_sub is None else n_sub
    st, gen = scenes(env, B, seed)
    over, gaps = {}, {}
    for n in (SHORT_SUBSTEPS, n_sub):
        out_k = solver_cuda.run_batched_sim(st, params, n)
        out_p = physics.run(st, params, n)
        for name, part, field in SOLVER_OUTPUTS:
            if not bool(torch.isfinite(getattr(getattr(out_k, part), field)).all()):
                raise RuntimeError(f"solver kernel produced non-finite {name} ({path} shapes)")
        gaps[n] = solver_gaps(out_k, out_p)
        bad = torch.zeros(B, dtype=torch.bool, device=dev)
        for name, g in gaps[n].items():
            bad |= ~(g <= SOLVER_TOL[name])
        over[n] = bad
    errs = {name: float(g.max()) for name, g in gaps[n_sub].items()}
    diverging = torch.nonzero(over[n_sub]).flatten().tolist()
    grasped = int(((out_p.gripper.finger_target == FINGER_CLOSED)
                   & (physics.gripper_width(out_p.gripper.q) > 0.005)).sum())
    log("solver_check", path=path, **({"call": call} if call else {}), B=B, seed=seed,
        n_substeps=n_sub, tol=SOLVER_TOL,
        max_abs_err={f"{n}_substeps": {name: float(g.max()) for name, g in gaps[n].items()}
                     for n in gaps},
        max_abs_err_outside_diverging_envs={
            name: float(torch.where(over[n_sub], 0.0, g).max())
            for name, g in gaps[n_sub].items()},
        envs_over_tol_short=torch.nonzero(over[SHORT_SUBSTEPS]).flatten().tolist(),
        diverging_envs={e: {name: float(gaps[n_sub][name][e]) for name in errs}
                        for e in diverging},
        diverging_cap=int(DIVERGING_ENV_FRAC * B),
        envs_closing=int((st.gripper.finger_target == FINGER_CLOSED).sum()),
        envs_holding=grasped)
    if bool(over[SHORT_SUBSTEPS].any()):
        raise RuntimeError(f"solver kernel disagrees with physics.run after {SHORT_SUBSTEPS} "
                           f"substeps ({path} shapes, {call or 'step'}, seed {seed})")
    if len(diverging) > DIVERGING_ENV_FRAC * B:
        raise RuntimeError(f"solver kernel disagrees with physics.run after {n_sub} substeps "
                           f"in {len(diverging)} of {B} envs ({path} shapes, {call or 'step'}, "
                           f"seed {seed}): {errs}")
    return st, out_p, gen, errs


SIMP_CALLS = ("move", "grasp", "lift")


def simplified_call_inputs(env, B, seed):
    """The inputs of the simplified step's three solver calls
    (grasp_env.py:592-606) on B scenes of `env` drawn from `seed`, each made
    from the one before through the kernel, as the main path makes them:
    reset scenes settled through the kernel with the second half of the
    batch lowered to 0.068 m over object slot 0, then random branched
    actions (the move call's input); the move call's output after the
    trigger, which closes the fingers of the envs below 0.07 m (the grasp
    call's input); the grasp call's output with the triggered envs' z
    target 5 cm up (the lift call's input). Returns {call: (state,
    n_substeps)}, the number of triggered envs and the generator."""
    import torch

    from deep_rl_grasping_tpu_torch.ops import solver_cuda

    dev, params = env.device, env.sim_params
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = env.reset_env(gen, B, 1.0, settle_substeps=48).sim
    half = torch.arange(B, device=dev) >= B // 2
    q = st.gripper.q.clone()
    q[half, 0:2] = st.objects.pos[half, 0, 0:2]
    q[half, 2] = 0.068
    st = st.replace(gripper=st.gripper.replace(q=q, target=q[:, :4].clone()))
    bins = torch.randint(0, env.actuator_spec.num_actions_pad, (B, 3), generator=gen,
                         device=dev)
    move_in, _ = env._apply_action(st, bins)
    moved = solver_cuda.run_batched_sim(move_in, params, env.move_substeps)
    grasp_in, trigger, _ = env._simplified_trigger(moved)
    grasped = solver_cuda.run_batched_sim(grasp_in, params, env.gripper_substeps)
    lift_in = env._simplified_lift(grasped, trigger)
    return ({"move": (move_in, env.move_substeps), "grasp": (grasp_in, env.gripper_substeps),
             "lift": (lift_in, 2 * env.move_substeps)}, int(trigger.sum()), gen)


def solver_cost(env, B, n_sub):
    """(operations, bytes) of one solver call of `n_sub` substeps on B envs."""
    params = env.sim_params
    K, S, SC = env.max_slots, params.radii.shape[1], params.oo_radii.shape[1]
    fl = solver_flops(B, K, S, SC, 5 if params.has_tray else 1, n_sub,
                      params.solver_iterations, params.pad_inner_iterations,
                      params.oo_pass_stride)
    io_bytes = 4 * B * (6 + 6 + 4 + 1 + K * (3 + 4 + 3 + 3 + 1 + S * 4 + SC * 4 + 1 + 3)
                        + 6 + 6 + K * (3 + 4 + 3 + 3))
    return fl, io_bytes


def simplified_solver_checks(path, env, B, full_step_ms):
    """The solver kernel on the simplified step's three calls at B envs:
    `solver_check` on each call's input for each of SOLVER_SEEDS, then the
    device ms, plain ms and bound of each call on the first seed's inputs.
    Logs `solver_simplified`; returns {call: (device ms, plain ms,
    operations, bytes, ms per Python call, substeps)} and the largest
    error."""
    import torch

    from deep_rl_grasping_tpu_torch.ops import solver_cuda
    from deep_rl_grasping_tpu_torch.sim import physics

    params = env.sim_params
    errs, first, triggered = {}, None, []
    for seed in SOLVER_SEEDS:
        inputs, n_trig, gen = simplified_call_inputs(env, B, seed)
        triggered.append(n_trig)
        first = first or inputs
        for call in SIMP_CALLS:
            st, n = inputs[call]
            e = solver_check(path, env, B, seed, scenes=lambda *_: (st, gen), n_sub=n,
                             call=call)[3]
            errs[call] = max(errs.get(call, 0.0), max(e.values()))
    timing = {}
    for call in SIMP_CALLS:
        st, n = first[call]
        k_in = solver_cuda.kernel_inputs(st, params)
        fn = lambda: solver_cuda.run_batch(*k_in, params=params, n_substeps=n)
        fl, nb = solver_cost(env, B, n)
        timing[call] = (device_ms(fn, torch), cuda_ms(lambda: physics.run(st, params, n), 2,
                                                        torch), fl, nb, cuda_ms(fn, 10, torch), n)
    bound = lambda t: max(t[3] / HBM_BYTES_PER_S, t[2] / FP32_FLOPS_PER_S) * 1e3
    log("solver_simplified", path=path, B=B, triggered_envs=triggered, timing=TIMING,
        calls={c: {"n_substeps": first[c][1], "kernel_ms": t[0], "plain_ms": t[1],
                   "call_ms": t[4], "bound_ms": bound(t), "flops": t[2], "bytes": t[3],
                   "max_abs_err": errs[c]} for c, t in timing.items()},
        kernel_ms_per_control_step=sum(t[0] for t in timing.values()),
        full_task_kernel_ms_per_control_step=full_step_ms)
    if min(triggered) <= 0:
        raise RuntimeError(f"no env triggered a grasp in the simplified solver check ({path})")
    return timing, max(errs.values())


def raster_scenes(env, B, sim, gen):
    """The raster checks' scenes: env states drawn from `gen` around the
    sim state `sim` (the solver check's result), with the grippers yawed
    over the whole circle, so the camera and the finger pads turn with
    them. Returns the env state and render_batch's positional arguments."""
    import torch

    from deep_rl_grasping_tpu_torch.render import raycast

    rs = env.reset_env(gen, B, 1.0)
    q = sim.gripper.q.clone()
    q[:, 3] = torch.linspace(-3.1, 3.1, B, device=env.device)
    rs = rs.replace(sim=sim.replace(gripper=sim.gripper.replace(q=q)))
    cam_pos, cam_R = raycast.camera_pose_from_gripper(rs.sim.gripper.q, rs.cam_t, rs.cam_R)
    return rs, (rs.sim, env.sim_params, cam_pos, cam_R, rs.intrinsics, env.im_h, env.im_w,
                env.near, env.far)


def kernel_checks(path, env, B, scenes=solver_check_scenes):
    """Solver, raster (depth + seg) and raster-with-shade kernels against
    their plain versions on one path's states (B envs of `env`, on the
    card, drawn by `scenes`); logs one line per kernel and raises on a
    disagreement. Returns the errors, times and bounds. The solver is
    checked on the scenes of each of SOLVER_SEEDS; the raster on the first
    seed's."""
    import torch

    from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda
    from deep_rl_grasping_tpu_torch.render import raycast
    from deep_rl_grasping_tpu_torch.sim import physics

    params, n_sub = env.sim_params, env.gripper_substeps
    runs = [solver_check(path, env, B, seed, scenes=scenes) for seed in SOLVER_SEEDS]
    errs = {k: max(r[3][k] for r in runs) for k in SOLVER_TOL}
    st, out_p, gen, _ = runs[0]
    k_in = solver_cuda.kernel_inputs(st, params)
    solver_fn = lambda: solver_cuda.run_batch(*k_in, params=params, n_substeps=n_sub)
    solver_call_ms = cuda_ms(solver_fn, 10, torch)
    solver_ms = device_ms(solver_fn, torch)
    solver_plain_ms = cuda_ms(lambda: physics.run(st, params, n_sub), 2, torch)
    K, S = st.objects.pos.shape[1], params.radii.shape[1]
    fl, io_bytes = solver_cost(env, B, n_sub)
    log("solver", path=path, B=B, n_substeps=n_sub, max_abs_err=errs, seeds=SOLVER_SEEDS,
        kernel_ms=solver_ms, timing=TIMING, call_ms=solver_call_ms, plain_ms=solver_plain_ms,
        bound_ms=max(io_bytes / HBM_BYTES_PER_S, fl / FP32_FLOPS_PER_S) * 1e3,
        flops=fl, bytes=io_bytes)

    rs, args = raster_scenes(env, B, out_p, gen)
    # per-env camera spread: 0 for the nominal camera, > 0 when randomized
    spread = {"intrinsics": float((rs.intrinsics - rs.intrinsics[:1]).abs().max()),
              "cam_R": float((rs.cam_R - rs.cam_R[:1]).abs().max())}
    H, W = env.im_h, env.im_w
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
    # the per-tile cull drops only spheres no ray of the tile hits: a launch
    # with every live sphere in every tile's list gives the same bits, and
    # so does a repeat (which also reads back the tile lists: they must be
    # the twin's up to rounding, and give the pairs the kernel tests)
    off = raster_cuda.raster_depth_seg(*r_args, **r_kw, cull=False)
    *again, lists = raster_cuda.launch(r_args, **r_kw, lists=True)
    cull_equal = bool(torch.equal(off[0], d_k) and torch.equal(off[1], s_k))
    repeat_equal = bool(torch.equal(again[0], d_k) and torch.equal(again[1], s_k))
    twin = raster_cuda.check_lists(lists, r_args[0], r_args[1], *r_args[5:], H, W)
    pairs = raster_cuda.pairs_tested(lists, H, W)
    raster_fn = lambda: raster_cuda.raster_depth_seg(*r_args, **r_kw)
    raster_call_ms = cuda_ms(raster_fn, 50, torch)
    raster_glue_ms = cuda_ms(lambda: raster_cuda.render_batch(*args), 20, torch)
    raster_plain_ms = cuda_ms(lambda: raycast.render(*args), 5, torch)
    raster_ms = device_ms(raster_fn, torch)
    P = K * S
    n_walls = 4 if params.has_tray else 0
    tiles = raster_cuda.launch_config(B, P, H, W)["tiles"]
    # operations: per pixel the ray and plane (30), three gripper boxes (45
    # each) and the walls (35 each); per pixel-sphere pair the kernel tests
    # (from its own lists) 25; per tile the cone (175) and per tile and
    # sphere the cull (55). The all-pairs count, every pixel against every
    # sphere, is the bound the first design (one thread per pixel over all
    # spheres) was held to.
    pair_count = pairs * B * H * W * P
    per_pixel = B * H * W * (20 + 10 + 3 * 45 + n_walls * 35)
    r_flops = per_pixel + pair_count * 25 + B * tiles * (175 + P * 55)
    r_flops_all = per_pixel + B * H * W * P * 25
    r_bytes = 4 * B * (P * 5 + 9 + 9 + 3 + 9 + 4) + 8 * B * H * W
    log("raster", path=path, B=B, H=H, W=W, P=P, camera_spread=spread,
        depth_max_abs_err=depth_err, depth_px_over_tol=n_over, depth_tol=DEPTH_TOL,
        depth_edge_tol=DEPTH_EDGE_TOL,
        worst_px={"seg": int(s_p.reshape(-1)[worst]), "depth": float(d_p.reshape(-1)[worst])},
        seg_mismatch_px=mismatch, seg_mismatch_cap=int(SEG_MISMATCH_FRAC * B * H * W),
        object_px=int((s_p > 0).sum()), cull_off_bit_equal=cull_equal,
        repeat_bit_equal=repeat_equal, lists_vs_twin=twin, pairs_tested=pairs,
        tile=raster_cuda.TILE, kernel_ms=raster_ms, timing=TIMING, call_ms=raster_call_ms,
        kernel_with_gather_ms=raster_glue_ms,
        plain_ms=raster_plain_ms,
        bound_ms=max(r_bytes / HBM_BYTES_PER_S, r_flops / FP32_FLOPS_PER_S) * 1e3,
        bound_ms_all_pairs=max(r_bytes / HBM_BYTES_PER_S, r_flops_all / FP32_FLOPS_PER_S) * 1e3,
        flops=r_flops, flops_all_pairs=r_flops_all, bytes=r_bytes)
    if (not depth_err <= DEPTH_EDGE_TOL or n_over > DEPTH_OVER_FRAC * B * H * W
            or mismatch > SEG_MISMATCH_FRAC * B * H * W):
        raise RuntimeError(f"raster kernel disagrees with raycast.render ({path} shapes)")
    if not (cull_equal and repeat_equal):
        raise RuntimeError(f"raster kernel: culled, cull-off and repeated launches differ "
                           f"({path} shapes)")
    if any(twin.values()):
        raise RuntimeError(f"raster kernel's tile lists differ from the plain twin of its cull "
                           f"({path} shapes): {twin}")

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
    off = raster_cuda.raster_depth_seg(*r_args, **r_kw, with_shade=True, cull=False)
    *again, shade_lists = raster_cuda.launch(r_args, **r_kw, with_shade=True, lists=True)
    shade_cull_equal = all(torch.equal(x, y) for x, y in zip(off, (d_ks, s_ks, sh_k)))
    shade_repeat_equal = all(torch.equal(x, y) for x, y in zip(again, (d_ks, s_ks, sh_k)))
    lists_equal = bool(torch.equal(shade_lists, lists))
    shade_fn = lambda: raster_cuda.raster_depth_seg(*r_args, **r_kw, with_shade=True)
    shade_call_ms = cuda_ms(shade_fn, 50, torch)
    shade_plain_ms = cuda_ms(lambda: raycast.render_shade(*args), 5, torch)
    shade_ms = device_ms(shade_fn, torch)
    # the shade adds, per pixel, the winner's normal and Lambert term (~30
    # operations) and a select per candidate; per pixel 4 more output bytes
    s_flops = r_flops + B * H * W * (30 + 3 + n_walls) + pair_count
    s_flops_all = r_flops_all + B * H * W * (30 + P + 3 + n_walls)
    s_bytes = r_bytes + 4 * B * H * W
    log("raster_shade", path=path, B=B, H=H, W=W, depth_seg_equal_to_plain_launch=same_launch,
        shade_max_abs_err=shade_err, shade_px_over_tol=shade_over,
        shade_max_abs_err_to_plain_winner=float(direct.max()), crease_px=crease_px,
        rgb_equal_to_assembled_shade=rgb_assembled,
        rgb_max_abs_err_to_plain=float((rgb_k - rgb_p).abs()[same].max()),
        shade_tol=SHADE_TOL, shade_edge_tol=SHADE_EDGE_TOL, tie_tol=DEPTH_TOL,
        lit_px=int((sh_k > 0.35).sum()), cull_off_bit_equal=shade_cull_equal,
        repeat_bit_equal=shade_repeat_equal, lists_equal_to_depth_seg_launch=lists_equal,
        pairs_tested=pairs, kernel_ms=shade_ms,
        timing=TIMING, call_ms=shade_call_ms, plain_ms=shade_plain_ms,
        bound_ms=max(s_bytes / HBM_BYTES_PER_S, s_flops / FP32_FLOPS_PER_S) * 1e3,
        bound_ms_all_pairs=max(s_bytes / HBM_BYTES_PER_S, s_flops_all / FP32_FLOPS_PER_S) * 1e3,
        flops=s_flops, flops_all_pairs=s_flops_all, bytes=s_bytes)
    if (not same_launch or not rgb_assembled or not bool(torch.isfinite(sh_k).all())
            or not shade_err <= SHADE_EDGE_TOL or shade_over > SHADE_OVER_FRAC * B * H * W):
        raise RuntimeError("raster kernel's shade output disagrees with raycast.render_shade "
                           f"({path} shapes)")
    if not (shade_cull_equal and shade_repeat_equal and lists_equal):
        raise RuntimeError(f"raster kernel with shade: culled, cull-off and repeated launches "
                           f"or their tile lists differ ({path} shapes)")
    all_pairs = lambda fl_all: max(r_bytes / HBM_BYTES_PER_S, fl_all / FP32_FLOPS_PER_S) * 1e3
    return dict(solver_err=max(errs.values()), depth_err=depth_err, shade_err=shade_err,
                pairs_tested=pairs, bound_ms_all_pairs={"raster": all_pairs(r_flops_all),
                                                        "shade": all_pairs(s_flops_all)},
                solver=(solver_ms, solver_plain_ms, fl, io_bytes, solver_call_ms),
                raster=(raster_ms, raster_plain_ms, r_flops, r_bytes, raster_call_ms),
                shade=(shade_ms, shade_plain_ms, s_flops, s_bytes, shade_call_ms))


def band_2sigma(p, n=EPISODES):
    """The 2-sigma binomial band of a success rate p over n episodes."""
    half = 2.0 * (p * (1.0 - p) / n) ** 0.5
    return [p - half, p + half]


def same_scene_evals(bundle, scenes):
    """`run --npz bundle --scenes scenes` twice; raises unless both runs
    agree exactly. Returns both results with their wall seconds."""
    import numpy as np

    from deep_rl_grasping_tpu_torch.training import train

    same = [train.main(["run", "--npz", bundle, "--scenes", scenes]) for _ in range(2)]
    if same[0]["episodes"] != EPISODES or not np.isfinite(same[0]["mean_return"]):
        raise RuntimeError(f"same-scene evaluation of {bundle} is malformed: {same[0]}")
    if any(same[0][k] != same[1][k] for k in ("success_rate", "mean_return", "mean_length",
                                              "episode_cleared")):
        raise RuntimeError(f"two evaluations of {bundle} from the same scenes differ: {same}")
    return same


def train_and_run(phase, config_path, raster_key, run_phase, algo="SAC", root=None):
    """`train --algo algo` on `config_path` at full width with only
    TRAIN_CUTS (ONPOLICY_CUTS for PPO and TRPO) cut, into a temporary
    directory (or `root`, which keeps the config as config.yaml and the run
    as run/), launches counted from just before to just after; then `run
    --model` on its checkpoint. Logs `<phase>_start`, `<phase>` and
    `run_phase`; raises unless the solver and the raster launch
    `raster_key` were launched, every update ran and (with prioritized
    replay) priorities changed. Returns the launch counts."""
    import numpy as np
    import torch

    from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda
    from deep_rl_grasping_tpu_torch.training import train, trainer
    from deep_rl_grasping_tpu_torch.utils import config as cfg_util
    from deep_rl_grasping_tpu_torch.utils import io_utils

    cfg = cfg_util.load_config(config_path)
    tpu, algo_cfg = cfg["tpu"], cfg[algo]
    on_policy = algo in ON_POLICY
    if not on_policy:  # the demo ring keeps the capacity the uncut config gives it
        tpu.setdefault("demo_capacity", tpu["demo_frames"])
    cuts = {(algo if block == "ALGO" else block, key): v for (block, key), v in
            (ONPOLICY_CUTS if on_policy else TRAIN_CUTS).items()}
    for (block, key), value in cuts.items():
        cfg[block][key] = value
    prioritized = bool(algo_cfg.get("prioritized_replay", False)) and algo != "SAC"
    loss_keys = LOSS_KEYS[algo]
    if on_policy:
        n_steps = int(algo_cfg["n_steps"])
        updates_per_iter = (int(algo_cfg["n_epochs"]) * int(algo_cfg["n_minibatches"])
                            if algo == "PPO" else 1)
        shape = dict(n_steps=n_steps, frames_per_iteration=n_steps * tpu["num_envs"],
                     updates_per_iteration=updates_per_iter,
                     **{k: algo_cfg[k] for k in ("n_epochs", "n_minibatches", "clip_range",
                                                 "cg_iters", "max_kl", "vf_iters")
                        if k in algo_cfg})
    else:
        folded = copy.deepcopy(cfg)  # the learner's shape under tpu.update_batch_scale
        updates_per_iter = trainer.fold_updates(folded, algo)
        shape = dict(updates_per_step=updates_per_iter, batch_size=folded[algo]["batch_size"],
                     update_batch_scale=tpu.get("update_batch_scale", 1),
                     demo_fraction=tpu.get("demo_fraction", 0),
                     buffer_size=algo_cfg["buffer_size"], demo_capacity=tpu["demo_capacity"])
        if algo in ("DQN", "BDQ"):
            shape.update(prioritized_replay=prioritized,
                         exploration_frames=algo_cfg["exploration_fraction"]
                         * algo_cfg["total_timesteps"],
                         exploration_final_eps=algo_cfg["exploration_final_eps"])
    with (contextlib.nullcontext(root) if root else
          tempfile.TemporaryDirectory(prefix="chip_smoke_train_")) as tmp:
        cfg_path = os.path.join(tmp, "config.yaml")
        io_utils.save_yaml(cfg, cfg_path)
        model_dir = os.path.join(tmp, "run")
        log(f"{phase}_start", config=config_path, algo=algo,
            cuts={f"{b}.{k}": v for (b, k), v in cuts.items()},
            num_envs=tpu["num_envs"], layers=algo_cfg["layers"], **shape)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(solver_cuda, raster_cuda)
        tr = train.main(["train", "--config", cfg_path, "--algo", algo, "--model_dir",
                         model_dir, "--seed", "0"])
        launches = read_counts(solver_cuda, raster_cuda)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        (env_s, n_iter), (upd_s, n_upd_iter) = tr["phase_seconds"]["env"], \
            tr["phase_seconds"]["update"]
        n_updates = tr["updates"]
        losses = {k: tr["metrics"].get(k) for k in loss_keys}
        frames_per_iter = shape["frames_per_iteration"] if on_policy else tpu["num_envs"]
        steps_per_iter = frames_per_iter // tpu["num_envs"]
        log(phase, algo=algo, frames=tr["frames"], done=tr["done"],
            wall_seconds=tr["wall_seconds"], iterations=n_iter, updates=n_updates,
            env_frames_per_s_of_the_step=frames_per_iter / (env_s / n_iter),
            iteration_frames_per_s=n_iter * frames_per_iter / (env_s + upd_s),
            end_to_end_frames_per_s=tr["frames"] / tr["wall_seconds"],
            ms_per_env_step=env_s / (n_iter * steps_per_iter) * 1e3,
            ms_per_update=upd_s / max(n_updates, 1) * 1e3,
            ms_updates_per_iteration=upd_s / max(n_upd_iter, 1) * 1e3,
            curriculum_lambda=tr["curriculum_lambda"], success_rate=tr["success_rate"],
            episodes=tr["episodes"], losses=losses, eval=tr["eval"],
            replay_rows=tr["replay_rows"], rows_off_priority_1=tr["rows_off_priority_1"],
            max_memory_allocated_gib=peak_gib, launches=launches,
            checkpoint_step=tr["checkpoint_step"])
        if (not tr["done"] or tr["frames"] != cuts[(algo, "total_timesteps")]
                or n_updates != n_iter * updates_per_iter
                or not all(v is not None and np.isfinite(v) for v in losses.values())):
            raise RuntimeError(f"training run ({phase}) is malformed: {tr}")
        if prioritized and not tr["rows_off_priority_1"]:
            raise RuntimeError(f"prioritized updates of {phase} changed no priority: {tr}")
        if min(launches["solver"], launches[raster_key]) <= 0:
            raise RuntimeError(f"a kernel of the {phase} path was not launched: {launches}")

        # `run --model` on the checkpoint the training run wrote
        reset_counts(solver_cuda, raster_cuda)
        ev = train.main(["run", "--model", model_dir, "--episodes", str(EPISODES)])
        log(run_phase, episodes=ev["episodes"], success_rate=ev["success_rate"],
            mean_return=ev["mean_return"], wall_seconds=ev["wall_seconds"],
            launches=read_counts(solver_cuda, raster_cuda))
        if ev["episodes"] != EPISODES or not np.isfinite(ev["mean_return"]):
            raise RuntimeError(f"run --model result ({run_phase}) is malformed: {ev}")
    return dict(launches, replay_rows=tr["replay_rows"], frames=tr["frames"])


def export_and_compare(run, out, dev, phase_suffix=""):
    """`tools/export_policy` of the latest checkpoint of `run` into `out`,
    then `run --npz` of the bundle against `run --model` of the
    checkpoint, both from the JAX package's validation scenes: the same
    success rate, return and length, and the same first-step actions of
    the policy's mode (on the normalized observation where the config
    normalizes). Logs `export<suffix>` and `run_npz_vs_model<suffix>`;
    raises on a difference."""
    import torch

    from deep_rl_grasping_tpu_torch.algos.normalize import normalize_obs
    from deep_rl_grasping_tpu_torch.envs.grasp_env import BatchedGraspEnv, GraspEnv
    from deep_rl_grasping_tpu_torch.tools import export_policy
    from deep_rl_grasping_tpu_torch.training import train, trainer

    info = export_policy.main([run, "--out", out, "--latest"])
    log("export" + phase_suffix, bundle_bytes=os.path.getsize(info["path"]),
        source=info["source"], algo=info["algo"], checkpoint_step=info["checkpoint_step"],
        files=sorted(os.listdir(out)))
    res_npz = train.main(["run", "--npz", out, "--scenes", SIMP_SCENES])
    res_model = train.main(["run", "--model", run, "--scenes", SIMP_SCENES])
    config, pol_npz, norm_npz = train.load_bundle_actor(out, dev)
    _, pol_model, norm_model = train.load_checkpoint_actor(run, dev)
    algo = info["algo"]
    env = GraspEnv(config, evaluate=True, validate=True, device=dev,
                   encoder=trainer._maybe_load_encoder(config, dev))
    trainer.set_action_interface(env, algo, config)
    states = train.load_scenes(SIMP_SCENES, dev)
    obs = BatchedGraspEnv(env, EPISODES, torch.Generator(device=dev)).observe_batch(states)

    def first_actions(policy, norm):
        o = normalize_obs(norm, obs) if config.get("normalize") else obs
        return trainer.act(policy, o, None, deterministic=True)

    a_npz, a_model = first_actions(pol_npz, norm_npz), first_actions(pol_model, norm_model)
    actions_equal = torch.equal(a_npz, a_model)
    log("run_npz_vs_model" + phase_suffix, algo=algo, scenes=SIMP_SCENES,
        success_rate_npz=res_npz["success_rate"], success_rate_model=res_model["success_rate"],
        mean_return_npz=res_npz["mean_return"], mean_return_model=res_model["mean_return"],
        episodes=res_npz["episodes"], first_step_actions_equal=actions_equal,
        first_step_actions_distinct=int(torch.unique(a_npz, dim=0).shape[0]))
    if not actions_equal or any(res_npz[k] != res_model[k] for k in
                                ("success_rate", "mean_return", "mean_length", "episodes")):
        raise RuntimeError(f"run --npz of the export ({res_npz}) differs from run --model "
                           f"of the checkpoint ({res_model})")


def _same_state(a, b):
    """Exact equality of two checkpoint payloads (nested dicts, lists,
    tensors, numbers)."""
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_state(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    return a == b


def resume_and_export(root, first, dev):
    """The `resume` phase on the BDQ run that `train_and_run` left in
    `root` (see the module docstring). `first` holds that run's frames and
    replay rows. Returns the resumed run's launch counts."""
    import torch

    from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda
    from deep_rl_grasping_tpu_torch.training import callbacks as cb
    from deep_rl_grasping_tpu_torch.training import train, trainer
    from deep_rl_grasping_tpu_torch.utils import config as cfg_util

    cfg_path, run = os.path.join(root, "config.yaml"), os.path.join(root, "run")
    cfg = cfg_util.load_config(cfg_path)
    rows = train.ring_settings(cfg["tpu"])[0]
    want_rows = min(first["replay_rows"], rows)

    # the learner and the ring as the entry point restores them, on a fresh
    # trainer at full width, against the saved files
    t = trainer.Trainer(cfg, algo="BDQ", device=dev, seed=1)
    state = t.init_state()
    saved = cb.Checkpointer(run).restore(device=dev)
    state = train.restore_learner(t, state, saved, first["frames"])
    snap = cb.RingCheckpointer(run).restore_raw()
    t0 = time.perf_counter()
    restored = train.restore_ring(t, state, snap)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    buf, R = state.buffer, snap["obs"].shape[0]
    learner_equal = _same_state(t.algo.state_dict(), saved["algo_state"])
    rows_equal = all(torch.equal(getattr(buf, k)[:R].cpu(), snap[k])
                     for k in ("obs", "action", "reward"))
    priorities_equal = torch.equal(buf.priority[:R].cpu(), snap["priority"])
    seam_done = bool(buf.done[R - buf.batch_stride:R].all())
    done_equal = torch.equal(buf.done[:R - buf.batch_stride].cpu(),
                             snap["done"][:R - buf.batch_stride])
    off_one = int((snap["priority"] != 1.0).sum())
    counts_on_cpu = all(st["step"].device.type == "cpu" for st in t.algo.opt.state.values())
    del t, state, buf

    # the resumed run through the entry point, launches counted
    target = 2 * first["frames"]
    resumed = os.path.join(root, "resumed")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(solver_cuda, raster_cuda)
    tr = train.main(["train", "--config", cfg_path, "--algo", "BDQ", "--model_dir", resumed,
                     "--load_dir", run, "--timestep", str(target), "--seed", "0"])
    launches = read_counts(solver_cuda, raster_cuda)
    (env_s, n_iter), (upd_s, _) = tr["phase_seconds"]["env"], tr["phase_seconds"]["update"]
    log("resume", resume_frames=tr["resume_frames"], frames=tr["frames"], done=tr["done"],
        ring_rows_restored=tr["ring_rows_restored"], expected_ring_rows=want_rows,
        snapshot_rows=R, priorities_equal=priorities_equal, rows_off_priority_1=off_one,
        seam_done=seam_done, done_flags_equal=done_equal, ring_rows_equal=rows_equal,
        learner_state_equal=learner_equal, adam_counts_on_cpu=counts_on_cpu,
        ring_restore_seconds=restore_s,
        entry_ring_restore_seconds=tr["ring_restore_seconds"],
        ring_save={k: tr["ring_save"][k] for k in ("rows", "bytes", "seconds")},
        wall_seconds=tr["wall_seconds"], updates=tr["updates"],
        ms_per_env_step=env_s / n_iter * 1e3,
        ms_per_update=upd_s / max(tr["updates"] - saved["algo_state"]["step"], 1) * 1e3,
        end_to_end_frames_per_s=(tr["frames"] - tr["resume_frames"]) / tr["wall_seconds"],
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches)
    if not (learner_equal and rows_equal and priorities_equal and seam_done and done_equal
            and restored == want_rows and off_one > 0 and counts_on_cpu):
        raise RuntimeError("the restored learner or ring differs from the saved one")
    if (tr["resume_frames"] != first["frames"] or tr["frames"] != target or not tr["done"]
            or tr["ring_rows_restored"] != want_rows):
        raise RuntimeError(f"the resumed run is malformed: {tr}")
    if min(launches["solver"], launches["raster"]) <= 0:
        raise RuntimeError(f"a kernel of the resume path was not launched: {launches}")

    # export, then `run --npz` of the bundle against `run --model` of the
    # checkpoint, from the JAX package's validation scenes
    export_and_compare(resumed, os.path.join(root, "bundle"), dev)
    return launches


def encoder_check(st, dev):
    """The trained encoder of the encoder bundle on the card against the
    same module on the CPU, on the masked depth images the raster kernel
    renders for the stored scenes (B=100); and the latents of the kernel's
    render against those of the plain render. Logs one line; raises on a
    disagreement or a non-finite latent."""
    import torch

    from deep_rl_grasping_tpu_torch.envs.grasp_env import GraspEnv
    from deep_rl_grasping_tpu_torch.ops import raster_cuda
    from deep_rl_grasping_tpu_torch.render import raycast
    from deep_rl_grasping_tpu_torch.training import trainer
    from deep_rl_grasping_tpu_torch.utils import config as cfg_util

    config = cfg_util.load_config(os.path.join(ENCODER_BUNDLE, "config.yaml"))
    enc = trainer._maybe_load_encoder(config, dev)
    enc_cpu = trainer._maybe_load_encoder(config, "cpu")
    env = GraspEnv(config, evaluate=True, validate=True, device=dev, encoder=enc)
    cam_pos, cam_R = raycast.camera_pose_from_gripper(st.sim.gripper.q, st.cam_t, st.cam_R)
    args = (st.sim, env.sim_params, cam_pos, cam_R, st.intrinsics, env.im_h, env.im_w,
            env.near, env.far)
    with torch.no_grad():
        d_k, s_k = raster_cuda.render_batch(*args)
        img_k = env.encoder_input(d_k, s_k)[..., None]
        img_p = env.encoder_input(*raycast.render(*args))[..., None]
        z = enc(img_k)
        z_cpu = enc_cpu(img_k.cpu())
        z_plain = enc(img_p)
        enc_ms = cuda_ms(lambda: enc(img_k), 20, torch)
        obs_ms = cuda_ms(lambda: enc(env.encoder_input(d_k, s_k)[..., None]), 20, torch)
    gap = float((z.cpu() - z_cpu).abs().max())
    render_gap = (z - z_plain).abs().amax(-1)
    log("encoder", B=z.shape[0], encoding_dim=z.shape[1], encoder_dir=config["sensor"][
            "encoder_dir"], card_vs_cpu=gap, tol=ENCODER_TOL, latent_max_abs=float(z.abs().max()),
        masked_px_nonzero_frac=float((img_k > 0).float().mean()),
        mask_flips_kernel_vs_plain=int(((img_k > 0) != (img_p > 0)).sum()),
        kept_depth_max_abs_kernel_vs_plain=float(
            torch.where((img_k > 0) & (img_p > 0), img_k - img_p, 0.0).abs().max()),
        latent_gap_kernel_vs_plain_render={"max": float(render_gap.max()),
                                           "median_env": float(render_gap.median()),
                                           "envs_differing": int((render_gap > 0).sum())},
        encoder_ms_per_control_step=enc_ms, mask_and_encoder_ms=obs_ms, timing="cuda_events")
    if not (bool(torch.isfinite(z).all()) and gap <= ENCODER_TOL):
        raise RuntimeError(f"encoder on the card disagrees with the CPU: {gap}")


def two_sample_2sigma(values, other=EPISODES):
    """Two-sample 2-sigma of a difference of means from the per-episode
    values of both samples; `other` is the other sample's values, or only
    its size where its variance is taken as this sample's (the JAX CLI
    prints means only)."""
    import numpy as np

    v = np.asarray(values, np.float64)
    o = v if np.ndim(other) == 0 else np.asarray(other, np.float64)
    n_other = other if np.ndim(other) == 0 else o.size
    return 2.0 * float(np.sqrt(np.var(v) / v.size + np.var(o) / n_other))


def clearing_evals(dev):
    """`eval_clearing` and `eval_r5b` (see the module docstring). Returns
    the clearing eval's launch counts."""
    import numpy as np

    from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda
    from deep_rl_grasping_tpu_torch.training import train

    reset_counts(solver_cuda, raster_cuda)
    res = train.main(["run", "--npz", CLEARING_BUNDLE, "--episodes", str(EPISODES)])
    launches = read_counts(solver_cuda, raster_cuda)
    same = same_scene_evals(CLEARING_BUNDLE, CLEARING_SCENES)
    sr, cl = same[0]["success_rate"], same[0]["mean_cleared"]
    p = (sr + JAX_CLEARING["success_rate"]) / 2  # binomial, at the pair's mean rate
    sig_sr = 2.0 * (2 * p * (1 - p) / EPISODES) ** 0.5
    sig_cl = two_sample_2sigma(same[0]["episode_cleared"])
    log("eval_clearing", bundle=CLEARING_BUNDLE, episodes=res["episodes"],
        torch_scenes_success_rate=res["success_rate"],
        torch_scenes_mean_cleared=res["mean_cleared"],
        torch_scenes_episode_cleared=res["episode_cleared"],
        control_steps=res["control_steps"], mean_length=res["mean_length"],
        wall_seconds=res["wall_seconds"], launches=launches, scenes=CLEARING_SCENES,
        success_rate=sr, mean_cleared=cl, mean_return=same[0]["mean_return"],
        episode_cleared=same[0]["episode_cleared"],
        same_scene_control_steps=same[0]["control_steps"],
        same_scene_wall_seconds=[x["wall_seconds"] for x in same], repeat_equal=True,
        jax_cli=JAX_CLEARING, two_sample_2sigma={"success_rate": sig_sr, "mean_cleared": sig_cl},
        within_2sigma={"success_rate": abs(sr - JAX_CLEARING["success_rate"]) <= sig_sr,
                       "mean_cleared": abs(cl - JAX_CLEARING["mean_cleared"]) <= sig_cl})
    if (res["episodes"] != EPISODES or res["control_steps"] > 200
            or not np.isfinite(res["mean_return"]) or min(res["episode_cleared"]) < 0):
        raise RuntimeError(f"evaluation of {CLEARING_BUNDLE} is malformed: {res}")
    if min(launches["solver"], launches["raster"]) <= 0:
        raise RuntimeError(f"a kernel of the eval_clearing path was not launched: {launches}")
    same_b = same_scene_evals(R5B_BUNDLE, R5B_SCENES)
    sr_b = same_b[0]["success_rate"]
    log("eval_r5b", bundle=R5B_BUNDLE, scenes=R5B_SCENES, success_rate=sr_b,
        mean_return=same_b[0]["mean_return"], episodes=same_b[0]["episodes"],
        wall_seconds=[x["wall_seconds"] for x in same_b], repeat_equal=True, band=R5B_BAND,
        in_band=R5B_BAND[0] <= sr_b <= R5B_BAND[1])
    return launches


def expert_clearing(dev):
    """`expert_clearing`: the scripted expert on the clearing task at lambda
    0 and 1. Returns the launch counts of both runs."""
    from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda
    from deep_rl_grasping_tpu_torch.tools import expert_rate

    with open(JAX_EXPERT_CLEARING) as f:
        refs = {r["lam"]: r for r in map(json.loads, f)}
    total = {"solver": 0, "raster": 0, "raster_shade": 0}
    for lam in (0.0, 1.0):
        reset_counts(solver_cuda, raster_cuda)
        res = expert_rate.expert_rollouts(CLEARING_TRAIN_CONFIG, EXPERT_EPISODES, lam, device=dev)
        launches = read_counts(solver_cuda, raster_cuda)
        ref = refs[lam]
        sigma = {k: two_sample_2sigma(res[ep], ref[ep]) for k, ep in
                 (("success_rate", "episode_success"), ("mean_cleared", "episode_cleared"))}
        log("expert_clearing", config=CLEARING_TRAIN_CONFIG, lam=lam, episodes=res["episodes"],
            success_rate=res["success_rate"], mean_cleared=res["mean_cleared"],
            jax_cpu={k: ref[k] for k in ("episodes", "success_rate", "mean_cleared")},
            two_sample_2sigma=sigma,
            within_2sigma={k: abs(res[k] - ref[k]) <= sigma[k] for k in sigma},
            mean_length=res["mean_length"], episode_success=res["episode_success"],
            episode_cleared=res["episode_cleared"], control_steps=res["control_steps"],
            wall_seconds=res["wall_seconds"], launches=launches)
        if res["episodes"] != EXPERT_EPISODES or launches["solver"] <= 0:
            raise RuntimeError(f"expert rollouts on the clearing task are malformed: {res}")
        total = {k: total[k] + launches[k] for k in total}
    return total


def encoder_training(dev, root):
    """`collect_encoder`, `train_ae` and `ae_latent_step` (see the module
    docstring) in the directory `root`. Returns their launch counts."""
    import numpy as np
    import torch

    from deep_rl_grasping_tpu_torch.envs.grasp_env import BatchedGraspEnv, GraspEnv
    from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda
    from deep_rl_grasping_tpu_torch.training import collect_dataset, train_encoder, trainer
    from deep_rl_grasping_tpu_torch.utils import config as cfg_util
    from deep_rl_grasping_tpu_torch.utils import io_utils

    data = os.path.join(root, "dataset.npz")
    reset_counts(solver_cuda, raster_cuda)
    info = collect_dataset.main(["--config", AE_COLLECT_CONFIG, "--keep_task", "--mix_lambda",
                                 "--train", str(AE_IMAGES[0]), "--test", str(AE_IMAGES[1]),
                                 "--num_envs", "128", "--out", data, "--device", str(dev)])
    collect_launches = read_counts(solver_cuda, raster_cuda)
    with np.load(data) as f:
        shapes = {k: list(f[k].shape) for k in ("train", "test")}
        test_x = f["test"]
    log("collect_encoder", config=AE_COLLECT_CONFIG, images=info["images"], shapes=shapes,
        collect_seconds=info["collect_seconds"], nonzero_px_frac=info["nonzero_px_frac"],
        dataset_bytes=os.path.getsize(data), launches=collect_launches)
    if (shapes != {"train": [AE_IMAGES[0], 64, 64, 1], "test": [AE_IMAGES[1], 64, 64, 1]}
            or not 0.0 < info["nonzero_px_frac"] < 1.0
            or min(collect_launches["solver"], collect_launches["raster"]) <= 0):
        raise RuntimeError(f"the collected dataset is malformed: {info}, {collect_launches}")

    enc_dir, enc_cfg = os.path.join(root, "encoder"), os.path.join(root, "encoder.yaml")
    io_utils.save_yaml(dict(train_encoder.DEFAULT_ENCODER_CONFIG, epochs=AE_EPOCHS), enc_cfg)
    torch.cuda.reset_peak_memory_stats()
    tr = train_encoder.main(["train", "--config", enc_cfg, "--data", data, "--model_dir",
                             enc_dir, "--device", str(dev)])
    test_mse = train_encoder.main(["test", "--data", data, "--model_dir", enc_dir,
                                   "--device", str(dev)])
    cpu_mse = train_encoder.main(["test", "--data", data, "--model_dir", enc_dir,
                                  "--device", "cpu"])
    zero_mse = float((test_x ** 2).mean())
    history = open(os.path.join(enc_dir, "history.csv")).read().split()[1:]
    log("train_ae", **tr, test_mse=test_mse, test_mse_cpu_same_weights=cpu_mse,
        test_mse_of_zeros=zero_mse, history=history,
        files=sorted(os.listdir(enc_dir)), weights_bytes=os.path.getsize(
            os.path.join(enc_dir, "weights.npz")),
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if (tr["epochs"] != AE_EPOCHS or not np.isfinite(test_mse) or not test_mse < zero_mse
            or abs(cpu_mse - test_mse) > 0.05 * test_mse):
        raise RuntimeError(f"autoencoder training is malformed: {tr}, test {test_mse}, "
                           f"cpu {cpu_mse}, zeros {zero_mse}")

    cfg = cfg_util.load_config(ENCODER_TRAIN_CONFIG)
    cfg["sensor"]["encoder_dir"] = enc_dir
    enc = trainer._maybe_load_encoder(cfg, dev)
    env = GraspEnv(cfg, device=dev, encoder=enc)
    B = int(cfg["tpu"]["num_envs"])
    benv = BatchedGraspEnv(env, B, torch.Generator(device=dev).manual_seed(0))
    cur = benv.init_curriculum()
    reset_counts(solver_cuda, raster_cuda)
    with torch.no_grad():
        states, obs = benv.reset(cur)
        _, obs2, reward, _, _, _ = benv.step(states, torch.zeros(B, env.action_dim, device=dev),
                                             cur)
    step_launches = read_counts(solver_cuda, raster_cuda)
    log("ae_latent_step", encoder_dir=enc_dir, B=B, obs_shape=list(obs2.shape),
        latent_max_abs=float(obs2[:, :env.encoding_dim].abs().max()),
        latent_env_spread=float(obs2[:, :env.encoding_dim].std(0).mean()),
        finite=bool(torch.isfinite(obs2).all()), reward_mean=float(reward.mean()),
        launches=step_launches)
    if (tuple(obs2.shape) != (B, env.encoding_dim + 1) or not bool(torch.isfinite(obs2).all())
            or min(step_launches["solver"], step_launches["raster"]) <= 0):
        raise RuntimeError(f"a latent env step with the trained encoder is malformed: "
                           f"{tuple(obs2.shape)}, {step_launches}")
    return {"collect_encoder": collect_launches, "ae_latent_step": step_launches}


def kernel_entry(name, source, replaces, launches, launches_by_path, max_abs_err, timing,
                 **extra):
    """One entry of the `kernels` line from (device ms, plain ms, operations,
    bytes, ms per Python call)."""
    ms, plain_ms, flops, nbytes, call_ms = timing
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_by_path": launches_by_path,
            "max_abs_err": max_abs_err, "ms": ms, "timing": TIMING, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes", "library_ms": None,
            **extra}


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
    ptxas = {src: [ln.strip() for ln in text.splitlines()
                   if "registers" in ln or "spill" in ln or "stack frame" in ln]
             for src, text in lib.logs.items()}
    log("build", seconds=round(lib.build_seconds, 3), reused=lib.reused, ptxas=ptxas)
    solver_res = solver_cuda.kernel_attributes()

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
        p = penv.sim_params
        cfg = solver_cuda.launch_config(B, penv.max_slots, p.radii.shape[1],
                                        p.oo_radii.shape[1], p.has_tray)
        solver_res[f"shared_bytes_{path}"] = cfg["shared_bytes"]
        solver_res[f"launch_{path}"] = [cfg["blocks"], cfg["threads"]]
    log("solver_resources", **solver_res)
    if solver_res["local_bytes"] != 0:
        raise RuntimeError(f"the solver kernel uses per-thread local memory: {solver_res}")
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
    log("eval", episodes=res["episodes"], success_rate=sr, mean_return=res["mean_return"],
        mean_length=res["mean_length"], control_steps=res["control_steps"],
        wall_seconds=res["wall_seconds"], launches=launches,
        jax_reference_val=JAX_VAL[BUNDLE], band_2sigma=band_2sigma(JAX_VAL[BUNDLE]))
    if res["episodes"] != EPISODES or not 0.0 <= sr <= 1.0 or not np.isfinite(res["mean_return"]):
        raise RuntimeError(f"evaluation result is malformed: {res}")
    if min(launches["solver"], launches["raster"]) <= 0:
        raise RuntimeError(f"a kernel of the eval path was not launched: {launches}")

    # ---- 5b. the same bundle from the JAX package's own 100 validation
    # scenes (its PRNGKey(1) reset), twice: a check of scene luck against
    # the JAX figure, and of determinism (both runs must agree exactly)
    same = same_scene_evals(BUNDLE, SCENES)
    log("eval_same_scenes", scenes=SCENES,
        success_rate=same[0]["success_rate"], mean_return=same[0]["mean_return"],
        episodes=same[0]["episodes"], control_steps=same[0]["control_steps"],
        wall_seconds=[x["wall_seconds"] for x in same], repeat_equal=True,
        torch_scenes_success_rate=sr, jax_reference_val=JAX_VAL[BUNDLE],
        band_2sigma=band_2sigma(JAX_VAL[BUNDLE]))

    # ---- 6-7. train: `train` on the RGB-D flagship at full width, launches
    # counted; then `run --model` on its checkpoint
    train_launches = train_and_run("train", TRAIN_CONFIG, "raster_shade", "run_model")

    # ---- 8. the encoder: card vs CPU, kernel's render vs the plain one
    encoder_check(train.load_scenes(SCENES, dev), dev)

    # ---- 9. eval_encoder: `run --npz` of the encoder-latent bundle through
    # the entry point, launches counted; then twice from the JAX package's
    # validation scenes, which are those of the r5c bundle (ENCODER_BUNDLE)
    reset_counts(solver_cuda, raster_cuda)
    res_e = train.main(["run", "--npz", ENCODER_BUNDLE, "--episodes", str(EPISODES)])
    enc_launches = read_counts(solver_cuda, raster_cuda)
    same_e = same_scene_evals(ENCODER_BUNDLE, SCENES)
    sr_e, band_e = same_e[0]["success_rate"], band_2sigma(JAX_VAL[ENCODER_BUNDLE])
    log("eval_encoder", bundle=ENCODER_BUNDLE, episodes=res_e["episodes"],
        torch_scenes_success_rate=res_e["success_rate"],
        torch_scenes_mean_return=res_e["mean_return"], mean_length=res_e["mean_length"],
        control_steps=res_e["control_steps"], wall_seconds=res_e["wall_seconds"],
        depth_bundle_wall_seconds=res["wall_seconds"], launches=enc_launches, scenes=SCENES,
        success_rate=sr_e, mean_return=same_e[0]["mean_return"],
        same_scene_wall_seconds=[x["wall_seconds"] for x in same_e],
        depth_bundle_same_scene_wall_seconds=[x["wall_seconds"] for x in same],
        repeat_equal=True, jax_reference_val=JAX_VAL[ENCODER_BUNDLE], band_2sigma=band_e,
        in_band=band_e[0] <= sr_e <= band_e[1])
    if (res_e["episodes"] != EPISODES or not 0.0 <= res_e["success_rate"] <= 1.0
            or not np.isfinite(res_e["mean_return"])):
        raise RuntimeError(f"evaluation of {ENCODER_BUNDLE} is malformed: {res_e}")
    if min(enc_launches["solver"], enc_launches["raster"]) <= 0:
        raise RuntimeError(f"a kernel of the eval_encoder path was not launched: {enc_launches}")

    # ---- 10. train_encoder_latent: `train` on latents at full width, then
    # `run --model` on its checkpoint
    latent_launches = train_and_run("train_encoder_latent", ENCODER_TRAIN_CONFIG, "raster",
                                    "run_model_encoder_latent")

    # ---- 11. the simplified step's three solver calls (move 8, grasp 16,
    # lift 16 substeps), kernel vs plain on inputs made through the kernel,
    # at the eval shape (the BDQ bundle's config, B=100) and the train shape
    # (configs/bdq_simplified.yaml, B=128); their device ms per control
    # step beside the full task's one launch at the same B
    from deep_rl_grasping_tpu_torch.training.trainer import (_maybe_load_encoder,
                                                             set_action_interface)

    simp = {}
    for path, cfg_path, evaluate, full in (
            ("eval_simplified", os.path.join(BDQ_BUNDLE, "config.yaml"), True, checks["eval"]),
            ("train_simplified", BDQ_TRAIN_CONFIG, False, checks["train"])):
        scfg = cfg_util.load_config(cfg_path)
        senv = GraspEnv(scfg, evaluate=evaluate, validate=evaluate, device=dev,
                        encoder=_maybe_load_encoder(scfg, dev))
        set_action_interface(senv, "BDQ", scfg)
        B = EPISODES if evaluate else int(scfg["tpu"]["num_envs"])
        simp[B] = simplified_solver_checks(path, senv, B, full["solver"][0])
    solver_err = max(solver_err, *(err for _, err in simp.values()))

    # ---- 12. eval_bdq, eval_dqn: `run --npz` of the simplified-task
    # bundles through the entry point, launches counted; then each twice
    # from the JAX package's validation scenes of these bundles
    simp_launches = {}
    for phase, bundle in (("eval_bdq", BDQ_BUNDLE), ("eval_dqn", DQN_BUNDLE)):
        reset_counts(solver_cuda, raster_cuda)
        res_s = train.main(["run", "--npz", bundle, "--episodes", str(EPISODES)])
        simp_launches[phase] = read_counts(solver_cuda, raster_cuda)
        same_s = same_scene_evals(bundle, SIMP_SCENES)
        sr_s, band_s = same_s[0]["success_rate"], band_2sigma(JAX_VAL[bundle])
        log(phase, bundle=bundle, episodes=res_s["episodes"],
            torch_scenes_success_rate=res_s["success_rate"],
            torch_scenes_mean_return=res_s["mean_return"], mean_length=res_s["mean_length"],
            control_steps=res_s["control_steps"], wall_seconds=res_s["wall_seconds"],
            depth_bundle_wall_seconds=res["wall_seconds"],
            depth_bundle_control_steps=res["control_steps"],
            launches=simp_launches[phase], scenes=SIMP_SCENES, success_rate=sr_s,
            mean_return=same_s[0]["mean_return"], same_scene_mean_length=same_s[0]["mean_length"],
            same_scene_control_steps=same_s[0]["control_steps"],
            same_scene_wall_seconds=[x["wall_seconds"] for x in same_s], repeat_equal=True,
            jax_reference_val=JAX_VAL[bundle], band_2sigma=band_s,
            in_band=band_s[0] <= sr_s <= band_s[1])
        if (res_s["episodes"] != EPISODES or not 0.0 <= res_s["success_rate"] <= 1.0
                or not np.isfinite(res_s["mean_return"])):
            raise RuntimeError(f"evaluation of {bundle} is malformed: {res_s}")
        if min(simp_launches[phase]["solver"], simp_launches[phase]["raster"]) <= 0:
            raise RuntimeError(f"a kernel of the {phase} path was not launched: "
                               f"{simp_launches[phase]}")

    # ---- 13. train_bdq, train_dqn: `train` on the simplified configs at
    # full width, prioritized, then `run --model` on each checkpoint
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bdq_") as bdq_root:
        first = train_and_run("train_bdq", BDQ_TRAIN_CONFIG, "raster", "run_model_bdq",
                              algo="BDQ", root=bdq_root)
        simp_launches["train_bdq"] = first

        # ---- 14. resume: `train --load_dir` on the BDQ run, export, and
        # `run --npz` of the export against `run --model` of the checkpoint
        simp_launches["resume"] = resume_and_export(bdq_root, first, dev)
    simp_launches["train_dqn"] = train_and_run("train_dqn", DQN_TRAIN_CONFIG, "raster",
                                               "run_model_dqn", algo="DQN")

    # ---- 15. train_ddpg, train_ppo, train_trpo: the continuous simplified
    # task at full width (DDPG: 64 uniform updates of batch 64, demo
    # seeding; PPO, TRPO: 128 envs x 64 steps per policy iteration, two
    # iterations), then `run --model` on each checkpoint; and the PPO
    # checkpoint exported and evaluated as `run --npz` against `run --model`
    simp_launches["train_ddpg"] = train_and_run("train_ddpg", DDPG_TRAIN_CONFIG, "raster",
                                                "run_model_ddpg", algo="DDPG")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ppo_") as ppo_root:
        simp_launches["train_ppo"] = train_and_run("train_ppo", PPO_TRAIN_CONFIG, "raster",
                                                   "run_model_ppo", algo="PPO", root=ppo_root)
        export_and_compare(os.path.join(ppo_root, "run"), os.path.join(ppo_root, "bundle"), dev,
                           "_ppo")
    simp_launches["train_trpo"] = train_and_run("train_trpo", TRPO_TRAIN_CONFIG, "raster",
                                                "run_model_trpo", algo="TRPO")

    # ---- 16. table clearing on the tray: the kernels on the clearing
    # path's states, some just after a removal (eval: the bundle's config,
    # B=100; train: the training config, B=128, randomized cameras), and
    # the removal check; then the bundle's evaluations, r5b's gate, the
    # expert, and the full-width training run
    clear_env = GraspEnv(cfg_util.load_config(os.path.join(CLEARING_BUNDLE, "config.yaml")),
                         evaluate=True, validate=True, device=dev)
    clear_train_env = GraspEnv(cfg_util.load_config(CLEARING_TRAIN_CONFIG), device=dev)
    for path, penv, B in (("eval_clearing", clear_env, EPISODES),
                          ("train_clearing", clear_train_env,
                           int(clear_train_env.config["tpu"]["num_envs"]))):
        if not (penv.reward_spec.table_clearing and penv.sim_params.has_tray):
            raise RuntimeError(f"the {path} env should clear a table on the tray")
        checks[path] = kernel_checks(path, penv, B, scenes=clearing_scenes)
        removal_check(path, penv, B)
    solver_err = max(solver_err, *(checks[p]["solver_err"] for p in ("eval_clearing",
                                                                     "train_clearing")))
    depth_err = max(depth_err, *(checks[p]["depth_err"] for p in ("eval_clearing",
                                                                  "train_clearing")))
    new_launches = {"eval_clearing": clearing_evals(dev), "expert_clearing": expert_clearing(dev),
                    "train_clearing": train_and_run("train_clearing", CLEARING_TRAIN_CONFIG,
                                                    "raster", "run_model_clearing")}

    # ---- 17. the folded update: update_batch_scale 8 at full width
    new_launches["train_batched"] = train_and_run("train_batched", BATCHED_TRAIN_CONFIG, "raster",
                                                  "run_model_batched")

    # ---- 18. encoder training: collect, train, test, and a latent step
    # with the trained encoder
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ae_") as ae_root:
        new_launches.update(encoder_training(dev, ae_root))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a",
          flush=True)
    # times and bounds at the shapes of the path each kernel's launches come
    # from: the solver and the shade launch at the train path's (B=128),
    # the depth + seg launch at the eval path's (B=100)
    src = "deep_rl_grasping_tpu_torch/csrc/"
    by_path = lambda key: {"eval": launches[key], "train": train_launches[key],
                           "eval_encoder": enc_launches[key],
                           "train_encoder_latent": latent_launches[key],
                           **{p: c[key] for p, c in simp_launches.items()},
                           **{p: c[key] for p, c in new_launches.items()}}
    bound = lambda t: max(t[3] / HBM_BYTES_PER_S, t[2] / FP32_FLOPS_PER_S) * 1e3
    # the simplified step's calls, by B: device ms and bound of each
    simp_calls = {f"B={B}": {c: {"n_substeps": t[5], "device_ms": t[0], "bound_ms": bound(t)}
                             for c, t in timing.items()}
                  for B, (timing, _) in simp.items()}
    kernels = [
        kernel_entry("solver_kernel", src + "solver.cu",
                     "deep_rl_grasping_tpu/ops/solver_pallas.py:107", train_launches["solver"],
                     by_path("solver"), solver_err, checks["train"]["solver"],
                     ms_eval_shapes=checks["eval"]["solver"][0],
                     device_ms_16_substeps={"B=100": checks["eval"]["solver"][0],
                                            "B=128": checks["train"]["solver"][0]},
                     bound_ms_16_substeps={"B=100": bound(checks["eval"]["solver"]),
                                           "B=128": bound(checks["train"]["solver"])},
                     device_ms_8_substeps={k: v["move"]["device_ms"]
                                           for k, v in simp_calls.items()},
                     bound_ms_8_substeps={k: v["move"]["bound_ms"] for k, v in simp_calls.items()},
                     simplified_calls=simp_calls,
                     device_ms_16_substeps_clearing={
                         "B=100": checks["eval_clearing"]["solver"][0],
                         "B=128": checks["train_clearing"]["solver"][0]},
                     bound_ms_16_substeps_clearing={
                         "B=100": bound(checks["eval_clearing"]["solver"]),
                         "B=128": bound(checks["train_clearing"]["solver"])},
                     registers=solver_res["registers"], local_bytes=solver_res["local_bytes"],
                     shared_bytes=solver_res["shared_bytes_train"]),
        kernel_entry("raster_kernel", src + "raster.cu",
                     "deep_rl_grasping_tpu/ops/raster_pallas.py:39", launches["raster"],
                     by_path("raster"), depth_err, checks["eval"]["raster"],
                     pairs_tested=checks["eval"]["pairs_tested"],
                     bound_ms_all_pairs=checks["eval"]["bound_ms_all_pairs"]["raster"],
                     device_ms_clearing={"B=100": checks["eval_clearing"]["raster"][0],
                                         "B=128": checks["train_clearing"]["raster"][0]},
                     tile=raster_cuda.TILE),
        kernel_entry("raster_kernel_shade", src + "raster.cu",
                     "deep_rl_grasping_tpu/ops/raster_pallas.py:39 (with_shade, :204-205)",
                     train_launches["raster_shade"], by_path("raster_shade"), shade_err,
                     checks["train"]["shade"], pairs_tested=checks["train"]["pairs_tested"],
                     bound_ms_all_pairs=checks["train"]["bound_ms_all_pairs"]["shade"],
                     tile=raster_cuda.TILE),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
