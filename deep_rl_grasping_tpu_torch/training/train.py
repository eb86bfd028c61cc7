"""Command line entry point of the port (counterpart of
deep_rl_grasping_tpu/training/train.py).

    python -m deep_rl_grasping_tpu_torch.training.train train \
        --config configs/sac_rgbd_flagship.yaml --algo SAC|DQN|BDQ|DDPG|PPO|TRPO \
        --model_dir <dir> [--load_dir <dir>] [--timestep N] [--seed S] [-s] \
        [--device cuda|cpu]
    python -m deep_rl_grasping_tpu_torch.training.train run \
        --model <dir> [-b] | --npz trained/sac_full_flagship_r5c \
        [--episodes N | --scenes <npz>] [-t] [--stochastic] [--device cuda|cpu]

`train` is train.py:78-473: off-policy for
SAC, DQN, BDQ and DDPG (training/trainer.py), on-policy for PPO and TRPO
(training/onpolicy.py, train.py:149-155: a chunk is one policy iteration
of `n_steps` x num_envs frames, and there is no replay, demo seeding or
ring snapshot). `robot.discrete` is set for the two Q-learners, `-s`
selects the simplified task. It runs demo seeding and periodic refresh,
the chunk loop, the monitor, scalar, curriculum and TensorBoard logs,
`stop_at_sr`, the q-tripwire rollback (SAC with `q_clip`), the eval
cadence (protocol eval plus the eval at the training lambda), checkpoints
and the best model, replay-ring snapshots (the newest
`tpu.ring_checkpoint_rows` rows every `tpu.ring_checkpoint_every` frames
and at the end), SIGTERM handling and the `done:` / `stopped:` marker.
`--load_dir` resumes from the newest checkpoint and ring snapshot another
`train` of the port wrote (train.py:166-247): the learner with its
optimizer state, the normalizer moments, the curriculum and the frame
count, so that epsilon, the target-entropy anneal and the eval,
checkpoint, ring and demo-refresh cadences go on where they were (the
JAX loop restarts the cadences at 0, so a resume there evaluates and
checkpoints after its first chunk); then the ring, unless its stride or
observation width differs from this run's; demo seeding runs again,
since the demo ring is not saved. Each call appends one line to
<model_dir>/runs.jsonl (command, seed, card, frames; a resume into
another directory carries the earlier lines over).

`run` evaluates a checkpoint this port wrote (`--model`, latest or `-b`
best) or a policy bundle (`--npz`, committed or written by
tools/export_policy.py) of any of the six algorithms (PPO and TRPO act
with their policy's mode, as the JAX package's on-policy branch does,
train.py:488-491) on the 100-episode protocol (train.py:474), or from
stored scenes (`--scenes`, an npz of env states under `scene.*` such
as deep_rl_grasping_tpu_torch/data/simplified_r5_val_scenes.npz; one
episode per scene). Depth, RGB-D and encoder-latent observations (the CNN
or the MLP torso, as the config says), the full and the simplified task
are all taken.

With `tpu.sharded` a replay learner trains data-parallel
(parallel/train_dp.py, train.py:104-138): one rank per visible card over
NCCL (on the CPU, one gloo rank), rank 0 writing checkpoints and logs
(`run_training`); PPO and TRPO with `tpu.sharded` are refused
(`trainer.refuse_unported`). `tpu.update_batch_scale` folds the replay
learner's updates (`trainer.fold_updates`).

Both run on the card unless `--device cpu` is given; with no card and no
`--device cpu` they stop with an error instead of falling back.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import signal
import shlex
import subprocess
import sys
import time

import numpy as np
import torch

from deep_rl_grasping_tpu_torch.algos import replay as replay_mod
from deep_rl_grasping_tpu_torch.algos.bdq import BDQ
from deep_rl_grasping_tpu_torch.algos.ddpg import DDPG
from deep_rl_grasping_tpu_torch.algos.dqn import DQN
from deep_rl_grasping_tpu_torch.algos.normalize import NormalizerState, RunningMeanStd
from deep_rl_grasping_tpu_torch.algos.ppo import PPO
from deep_rl_grasping_tpu_torch.algos.trpo import TRPO
from deep_rl_grasping_tpu_torch.envs.actuator import ActuatorSpec
from deep_rl_grasping_tpu_torch.envs.grasp_env import (env_state_from_numpy, env_state_to_numpy,
                                                       observation_shape)
from deep_rl_grasping_tpu_torch.models.networks import SACActor
from deep_rl_grasping_tpu_torch.parallel import train_dp
from deep_rl_grasping_tpu_torch.training import callbacks as cb
from deep_rl_grasping_tpu_torch.training.onpolicy import OnPolicyTrainer
from deep_rl_grasping_tpu_torch.training.trainer import (ALGOS, OFF_POLICY, ON_POLICY, Evaluator,
                                                         Trainer, refuse_unported)
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils, policy_io
from deep_rl_grasping_tpu_torch.utils.tb_events import TensorBoardWriter

log = logging.getLogger(__name__)
# chunks in a row at lambda 1 with the success rate at tpu.stop_at_sr before
# an early stop (the JAX package's tpu.stop_at_patience default; no config
# sets it)
STOP_PATIENCE = 50
CURRICULUM_FIELDS = ("lam", "ring", "ptr", "filled", "sr_mean", "policy_iteration")


def set_precision():
    """Float32 matmuls and convolutions in full float32 (no TF32) on the
    card; the networks' bf16 layers are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _device(name):
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    return device


def card_info(device):
    """The card's name and power limit as nvidia-smi prints them
    (`name, power.limit`), or None on the CPU or without nvidia-smi."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def ring_settings(tpu):
    """(rows, every): the replay-ring snapshot of a config, the newest
    `rows` rows every `every` frames and at the end of `train`; rows 0
    turns snapshots off (train.py:206-216)."""
    return (int(tpu.get("ring_checkpoint_rows", 65536)),
            int(tpu.get("ring_checkpoint_every", 500_000)))


def _rms(r: RunningMeanStd):
    return {"mean": r.mean, "var": r.var, "count": r.count}


def make_trainer(config, algo, device, seed=0, dp=None):
    """The trainer of `algo`: the replay `Trainer` for the off-policy
    learners, the `OnPolicyTrainer` for PPO and TRPO; with `dp` (a
    `train_dp.DataParallel`), this rank's `train_dp.ShardedTrainer`."""
    if dp is not None:
        return train_dp.make_sharded_trainer(config, dp, algo=algo, seed=seed)
    cls = OnPolicyTrainer if algo.upper() in ON_POLICY else Trainer
    return cls(config, algo=algo, device=device, seed=seed)


def _bundle(trainer: Trainer, state):
    """Checkpoint payload (train.py:64-76): learner, normalizer moments and
    curriculum state. The per-env running returns are not saved."""
    cur = state.curriculum
    return {
        "algo_state": trainer.algo.state_dict(),
        "obs_rms": _rms(state.normalizer.obs_rms),
        "ret_rms": _rms(state.normalizer.ret_rms),
        "curriculum": {f: getattr(cur, f) for f in CURRICULUM_FIELDS},
    }


def restore_learner(trainer: Trainer, state, bundle, frames):
    """Put a checkpoint payload (`_bundle`) into a fresh trainer and loop
    state: the learner (params, target params, optimizer moments and
    counts, SAC's log_alpha), the normalizer moments and the curriculum,
    and the loop's frame count `frames` (train.py:166-204). The per-env
    running returns start at zero."""
    trainer.algo.load_state_dict(bundle["algo_state"])
    rms = lambda d: RunningMeanStd(mean=d["mean"], var=d["var"], count=d["count"])
    dev = trainer.device
    return state.replace(
        curriculum=state.curriculum.replace(**{k: v.to(dev) for k, v in
                                               bundle["curriculum"].items()}),
        normalizer=state.normalizer.replace(obs_rms=rms(bundle["obs_rms"]),
                                            ret_rms=rms(bundle["ret_rms"])),
        global_step=int(frames))


def restore_ring(trainer: Trainer, state, snap):
    """Restore a ring snapshot into the loop state's fresh replay. Returns
    the rows restored, or None when the snapshot's stride or observation
    width differs from this run's: then the restore is skipped with a
    warning (train.py:229-235; a capacity that differs is not guarded)."""
    width = int(np.prod(trainer.env.obs_shape))
    stride, got = int(snap["batch_stride"]), int(snap["obs"].shape[1])
    if stride != trainer.num_envs or got != width:
        log.warning("ring snapshot layout (stride %d, obs width %d) does not match this run "
                    "(stride %d, obs width %d); skipping the restore", stride, got,
                    trainer.num_envs, width)
        return None
    replay_mod.restore_snapshot(state.buffer, snap)
    return int(snap["n"])


def _cadence_start(frames, every, chunk):
    """The frame count at which a cadence of `every` frames, checked after
    each chunk of `chunk` frames from 0, last fired at or before `frames`."""
    period = chunk * max(math.ceil(every / chunk), 1)
    return frames - frames % period


def _save_ring(ring_ckpt, frames, buf, rows):
    t0 = time.perf_counter()
    snap = replay_mod.snapshot(buf, rows)
    ring_ckpt.save(frames, snap)
    nbytes = sum(v.numel() * v.element_size() for v in snap.values()
                 if isinstance(v, torch.Tensor))
    info = dict(frames=frames, rows=int(snap["obs"].shape[0]), n=snap["n"], bytes=nbytes,
                seconds=time.perf_counter() - t0)
    log.info("saved the replay-ring snapshot: %s", info)
    return info


def _runs_log(model_dir, load_dir, record):
    """Write <model_dir>/runs.jsonl: the lines of <load_dir>/runs.jsonl when
    resuming, then `record`."""
    lines = []
    prev = os.path.join(load_dir, "runs.jsonl") if load_dir else None
    if prev and os.path.exists(prev):
        with open(prev) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
    lines.append(json.dumps(record, sort_keys=True))
    with open(os.path.join(model_dir, "runs.jsonl"), "w") as f:
        f.write("\n".join(lines) + "\n")


def train(args):
    """`train`: `run_training` on one device; with `tpu.sharded`, one rank
    per visible card over NCCL (a CPU run: one rank, gloo), rank 0's result
    returned (parallel/train_dp.py `launch_train`)."""
    config = cfg_util.load_config(args.config)
    algo = args.algo.upper()
    if algo not in ALGOS:
        raise SystemExit(f"unknown algorithm {algo}; the port trains {', '.join(ALGOS)}")
    if not bool(config.get("tpu", {}).get("sharded", False)):
        return run_training(args)[0]
    refuse_unported(config["tpu"], algo)
    device = _device(args.device)
    if device.type == "cuda":
        world, backend = torch.cuda.device_count(), "nccl"
        devices = [f"cuda:{r}" for r in range(world)]
    else:
        world, backend, devices = 1, "gloo", ["cpu"]
    return train_dp.launch_train(args.argv, world, backend, devices)[0]["result"]


def run_training(args, dp=None):
    """The training loop of `train` on one device, or on one rank of a
    data-parallel run (`dp`, a `train_dp.DataParallel`: train.py:104-138,
    176-190, 333-455). Sharded, every rank steps its own envs and updates
    the shared learner; rank 0 alone writes the config, checkpoints (its
    learner and normalizer, so a bundle resumes at any world size), logs,
    TensorBoard, the evaluations and runs.jsonl, and the monitor CSV from
    every rank's episode ring, gathered; frames count every rank (world x
    the rank's step); ring snapshots and the q-tripwire are off, as in the
    JAX package; a resume gives every rank the same checkpoint, at the
    rank's step frames // world; and the ranks agree after every chunk
    whether to stop (SIGTERM on any rank, the end of the run), so that no
    rank waits alone in a collective. Returns (result, trainer, state)."""
    device = dp.device if dp is not None else _device(args.device)
    world = 1 if dp is None else dp.world
    lead = dp is None or dp.rank == 0
    set_precision()
    config = cfg_util.load_config(args.config)
    algo = args.algo.upper()
    off_policy = algo in OFF_POLICY
    model_dir = args.model_dir

    # CLI overrides (train_stable_baselines.py:34-50)
    if args.simple:
        config["simplified"] = True
    if args.shaped:
        config["reward"]["shaped"] = True
    if args.timestep:
        config.setdefault(algo, {})["total_timesteps"] = int(args.timestep)
    if args.timefeature:
        config["time_feature"] = True
    config["robot"]["discrete"] = algo in ("DQN", "BDQ")
    config["algorithm"] = algo.lower()
    if lead:
        os.makedirs(os.path.join(model_dir, "best_model"), exist_ok=True)
        io_utils.save_yaml(config, os.path.join(model_dir, "config.yaml"))
        io_utils.save_yaml(config, os.path.join(model_dir, "best_model", "config.yaml"))

    tpu = config.get("tpu", {})
    total_timesteps = int(config.get(algo, {}).get("total_timesteps", 1_000_000))
    eval_freq = int(tpu.get("eval_freq", 50_000))
    checkpoint_freq = int(tpu.get("checkpoint_freq", 25_000))
    # an on-policy chunk is one policy iteration (train.py:149-155)
    chunk_steps = max(int(tpu.get("chunk_steps", 20)), 1) if off_policy else 1

    t_start = time.perf_counter()
    trainer = make_trainer(config, algo, device, args.seed, dp)
    state = trainer.init_state()
    frames_per_chunk = world * chunk_steps * (trainer.num_envs if off_policy
                                              else trainer.frames_per_iteration)

    # resume: the newest checkpoint of --load_dir, then its ring snapshot,
    # before demo seeding (the demo ring is not saved: seeding refills it at
    # the restored curriculum lambda)
    resume_frames, ring_restored, ring_restore_s = 0, None, None
    if args.load_dir:
        prev = cb.Checkpointer(args.load_dir)
        resume_frames = int(prev.latest_step() or 0)
        state = restore_learner(trainer, state, prev.restore(device=device),
                                resume_frames // world)
        if dp is not None:
            train_dp.broadcast_learner(dp, trainer.algo)
        log.info("resumed the learner from %s at %d frames (lambda %.3f)", args.load_dir,
                 resume_frames, float(state.curriculum.lam))
    ring_rows, ring_every = ring_settings(tpu)
    ring_ckpt = (cb.RingCheckpointer(model_dir) if ring_rows > 0 and off_policy and dp is None
                 else None)
    if ring_ckpt is not None and args.load_dir:
        same_dir = os.path.abspath(args.load_dir) == os.path.abspath(model_dir)
        snap = (ring_ckpt if same_dir else cb.RingCheckpointer(args.load_dir)).restore_raw()
        if snap is None:
            log.info("no ring snapshot under %s; resuming with an empty replay ring",
                     args.load_dir)
        else:
            t0 = time.perf_counter()
            ring_restored = restore_ring(trainer, state, snap)
            ring_restore_s = time.perf_counter() - t0
            if ring_restored is not None:
                log.info("restored %d replay frames from the ring snapshot in %.3f s",
                         ring_restored, ring_restore_s)

    demo_frames = int(tpu.get("demo_frames", 0)) if off_policy else 0
    demo = None
    if demo_frames > 0:
        state, n_done, n_succ = trainer.seed_demos(state, demo_frames)
        demo = dict(episodes=n_done, successes=n_succ)
        log.info("seeded %d demo frames: %d episodes, %.1f%% success", demo_frames,
                 int(n_done), 100.0 * n_succ / max(n_done, 1.0))

    if lead:
        monitor = cb.MonitorLogger(model_dir)
        scalars = cb.ScalarLogger(model_dir)
        tb = TensorBoardWriter(os.path.join(model_dir, "tb"))
        eval_log = cb.ScalarLogger(model_dir, filename="eval_logs.csv")
        curr_log = cb.CurriculumLogger(model_dir)
        ckpt = cb.Checkpointer(model_dir)
    timer = cb.TrainingTimer()

    # Divergence tripwire: q_target_mean outside a band 2% inside SAC.q_clip
    # rolls the learner back to the last checkpoint (not when sharded).
    q_band = None
    qc = config.get("SAC", {}).get("q_clip")
    if qc and algo == "SAC" and dp is None:
        margin = 0.02 * (float(qc[1]) - float(qc[0]))
        q_band = [float(qc[0]) + margin, float(qc[1]) - margin]
    last_rollback = -10 ** 9

    demo_refresh_every = int(tpu.get("demo_refresh_every", 0)) if off_policy else 0
    demo_refresh_frames = int(tpu.get("demo_refresh_frames", 0))
    stop_at_sr = tpu.get("stop_at_sr")
    stop_streak = 0
    solved = False

    log.info("training %s for %d frames (%d envs on %d rank(s)) on %s", algo, total_timesteps,
             trainer.num_envs * world, world, device)
    frames = resume_frames
    last_eval, last_ckpt, last_demo, last_ring = (
        _cadence_start(frames, max(every, 1), frames_per_chunk)
        for every in (eval_freq, checkpoint_freq, demo_refresh_every, ring_every))
    saved_ckpt = False
    ring_save = None
    drained = [0] * world
    episodes = 0
    row, res = {}, {}
    term_requested = []
    prev_handler = signal.signal(signal.SIGTERM, lambda *_: term_requested.append(True))
    try:
        while frames < total_timesteps:
            stop = bool(term_requested)
            if dp is not None:
                stop = dp.any(stop)
            if stop:
                log.info("SIGTERM received; saving and exiting at %d frames", frames)
                break
            state, metrics = trainer.train_chunk(state, chunk_steps)
            frames = world * state.global_step
            timer.tick(frames_per_chunk)

            # one monitor row per episode finished in this chunk, rank by rank
            ring, ring_n = state.ep_ring[None], state.ep_ring_n.reshape(1)
            if dp is not None:
                ring = dp.gather(ring)
                ring_n = dp.gather(ring_n.to(torch.float64)).to(torch.int64)
            ring_n, R = ring_n.tolist(), ring.shape[1]
            episodes = sum(ring_n)
            for r, n in enumerate(ring_n):
                new = min(n - drained[r], R)
                if new > 0 and lead:
                    idx = torch.arange(n - new, n, device=ring.device) % R
                    monitor.log_episodes(ring[r, idx].cpu().tolist())
                drained[r] = n
            cur = state.curriculum
            sr, lam = float(cur.sr_mean), float(cur.lam)
            row = dict(success_rate=sr, curriculum_lambda=lam, steps_per_s=timer.steps_per_s,
                       **{k: float(v) for k, v in metrics.items()})
            if lead:
                scalars.log(frames, row)
                tb.add_scalars(frames, row)
                curr_log.log(int(cur.policy_iteration), lam)
                log.info("frames %d  sr %.3f  lambda %.2f  %.0f steps/s", frames, sr, lam,
                         timer.steps_per_s)

            # the curriculum and the frame count are the same on every rank,
            # so every rank reaches an early stop at the same chunk
            if stop_at_sr is not None:
                at_target = lam >= 1.0 and sr >= float(stop_at_sr)
                stop_streak = stop_streak + 1 if at_target else 0
                if stop_streak >= STOP_PATIENCE:
                    log.info("early stop: sr %.3f >= %.3f at lambda=1.0 for %d consecutive "
                             "chunks (%d frames)", sr, float(stop_at_sr), STOP_PATIENCE, frames)
                    solved = True
                    break

            qm = row.get("q_target_mean", math.nan)
            if (q_band and math.isfinite(qm) and saved_ckpt
                    and frames - last_rollback > checkpoint_freq
                    and not q_band[0] <= qm <= q_band[1]):
                log.warning("TRIPWIRE: q_target_mean %.3f outside feasible band [%.3f, %.3f] "
                            "at %d frames; rolling the learner back to checkpoint %s", qm,
                            q_band[0], q_band[1], frames, ckpt.latest_step())
                trainer.algo.load_state_dict(ckpt.restore(device=device)["algo_state"])
                last_rollback = frames

            if (demo_refresh_every and demo_refresh_frames
                    and frames - last_demo >= demo_refresh_every):
                state, n_done, n_succ = trainer.seed_demos(state, demo_refresh_frames)
                log.info("refreshed %d demo frames at lambda %.2f: %d episodes, %.1f%% "
                         "success", demo_refresh_frames, lam, int(n_done),
                         100.0 * n_succ / max(n_done, 1.0))
                last_demo = frames

            if frames - last_ckpt >= checkpoint_freq:
                if lead:
                    ckpt.save(frames, _bundle(trainer, state))
                last_ckpt, saved_ckpt = frames, True
            if ring_ckpt is not None and frames - last_ring >= ring_every:
                ring_save = _save_ring(ring_ckpt, frames, state.buffer, ring_rows)
                last_ring = frames
            if frames - last_eval >= eval_freq:
                if lead:
                    res = _evaluate(trainer, state, lam, frames, eval_log, tb, ckpt)
                last_eval = frames
    except KeyboardInterrupt:
        log.info("interrupted; saving the model")
    finally:
        signal.signal(signal.SIGTERM, prev_handler)

    if lead:
        ckpt.save(max(frames, 1), _bundle(trainer, state))
    if ring_ckpt is not None and (ring_save is None or ring_save["frames"] != frames):
        ring_save = _save_ring(ring_ckpt, max(frames, 1), state.buffer, ring_rows)
    if lead:
        for f in (monitor, scalars, eval_log, tb):
            f.close()
    done = frames >= total_timesteps or solved
    if done:
        log.info("done: %d frames", frames)
    else:
        log.info("stopped: %d frames (target %d)", frames, total_timesteps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t_start
    record = dict(
        command=" ".join(["python -m deep_rl_grasping_tpu_torch.training.train"]
                         + [shlex.quote(a) for a in args.argv]),
        seed=args.seed, device=str(device), card=card_info(device), load_dir=args.load_dir,
        start_frames=resume_frames, frames=frames, done=done, wall_seconds=wall,
        ring_rows_restored=ring_restored)
    if dp is not None:
        record.update(world=world, backend=torch.distributed.get_backend(dp.group))
    if lead:
        _runs_log(model_dir, args.load_dir, record)
    cur, buf = state.curriculum, state.buffer
    result = dict(frames=frames, done=done, wall_seconds=wall, resume_frames=resume_frames,
                  ring_rows_restored=ring_restored, ring_restore_seconds=ring_restore_s,
                  ring_save=ring_save, world=world, demo=demo,
                  curriculum_lambda=float(cur.lam), success_rate=float(cur.sr_mean),
                  episodes=episodes, metrics=row, eval=res,
                  updates=trainer.algo.step, phase_seconds=trainer.clock.totals(),
                  checkpoint_step=ckpt.latest_step() if lead else None,
                  replay_rows=None if buf is None else buf.size,
                  rows_off_priority_1=int((buf.priority[:buf.size] != 1.0).sum())
                  if trainer.prioritized else None)
    return result, trainer, state


def _evaluate(trainer, state, lam, frames, eval_log, tb, ckpt):
    """The eval cadence's work: the protocol evaluation, a second one at
    the training lambda while the curriculum ramps, the logs, and the best
    model. Returns the logged results."""
    actor, norm = trainer.policy, state.normalizer
    res = trainer.evaluate(actor, norm)
    for k in ("episode_success", "episode_cleared"):  # the scalar logs take means
        res.pop(k)
    log.info("eval @ %d: %s", frames, res)
    if lam < 1.0:
        res_tr = trainer.evaluate(actor, norm, lam=lam)
        res["train_lambda_success"] = float(res_tr["success_rate"])
        res["train_lambda"] = lam
        log.info("eval @ %d (training lambda %.3f): sr %.2f", frames, lam,
                 res["train_lambda_success"])
    eval_log.log(frames, res)
    tb.add_scalars(frames, {"eval_" + k: v for k, v in res.items()})
    if ckpt.save_best(frames, _bundle(trainer, state), res["mean_return"]):
        log.info("new best model (return %.1f)", res["mean_return"])
    return res


def train_rank(args, dp):
    """One rank of a data-parallel `train`: `run_training`'s result, and
    what is compared across ranks (the learner's state, the curriculum, the
    env states, the generators' states, the demo episodes seeded on this
    rank, the rank's own observation moments), the rank's peak device
    memory and its kernel launches, all on the host."""
    from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda

    result, trainer, state = run_training(args, dp)
    cur = state.curriculum
    return dict(
        result=result, rank=dp.rank, world=dp.world, step=state.global_step,
        num_envs=trainer.num_envs, learner=_to_host(trainer.algo.state_dict()),
        curriculum={f: getattr(cur, f).cpu() for f in CURRICULUM_FIELDS},
        env_states={k: torch.as_tensor(v) for k, v in
                    env_state_to_numpy(state.env_states).items()},
        generators={k: getattr(trainer, k + "_gen").get_state()
                    for k in ("env", "learn", "demo")},
        demo_local=trainer.demo_local,
        obs_rms={f: getattr(state.normalizer.obs_rms, f).detach().cpu()
                 for f in ("mean", "var", "count")},
        max_memory_allocated_gib=(torch.cuda.max_memory_allocated(dp.device) / 2 ** 30
                                  if dp.device.type == "cuda" else None),
        launches={"solver": solver_cuda.run_batch.launches,
                  "raster": raster_cuda.raster_depth_seg.launches,
                  "raster_shade": raster_cuda.raster_depth_seg.shade_launches})


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _policy_for(config, device):
    """An untrained policy of the kind a config trains: the SAC actor (the
    CNN torso on image observations, the MLP torso on latents), or the DQN,
    BDQ, DDPG, PPO or TRPO learner, on `device`."""
    algo = config.get("algorithm", "sac").upper()
    obs_shape = observation_shape(config)
    spec = ActuatorSpec.from_config(config)
    if algo == "SAC":
        layers = tuple(config.get("SAC", {}).get("layers", [64, 64]))
        return SACActor(obs_shape, spec.action_dim, layers,
                        image_obs=len(obs_shape) == 3).to(device)
    if algo == "DQN":
        return DQN(obs_shape, spec.num_discrete_actions, config, device)
    if algo == "BDQ":
        return BDQ(obs_shape, 3 if spec.simplified else 5, config, device)
    if algo == "DDPG":
        return DDPG(obs_shape, spec.action_dim, config, device)
    if algo in ON_POLICY:
        n = spec.num_discrete_actions if spec.discrete else spec.action_dim
        return {"PPO": PPO, "TRPO": TRPO}[algo](obs_shape, n, config, spec.discrete, device)
    raise SystemExit(f"unknown algorithm {algo}; the port evaluates {', '.join(ALGOS)}")


def policy_net(policy):
    """The network a policy bundle holds: the SAC actor itself, DDPG's
    actor, or the learner's network (Q network or actor-critic)."""
    if isinstance(policy, SACActor):
        return policy
    return policy.actor if isinstance(policy, DDPG) else policy.net


def load_scenes(path, device):
    """The env states stored under `scene.*` in an npz (such as the JAX
    package's validation scenes in deep_rl_grasping_tpu_torch/data/), on
    `device`."""
    with np.load(path) as data:
        arrays = {k[len("scene."):]: data[k] for k in data.files if k.startswith("scene.")}
    return env_state_from_numpy(arrays, device)


def load_bundle_actor(model_dir, device):
    """Build the policy for a committed bundle's config (a SAC actor, or a
    learner) and load its weights. Returns (config, policy, normalizer)."""
    config = cfg_util.load_config(os.path.join(model_dir, "config.yaml"))
    policy = _policy_for(config, device)
    net, normalizer, _meta = policy_io.load_policy(
        model_dir, policy_net(policy), device, algo=config.get("algorithm", "sac").upper())
    net.eval()
    return config, policy, normalizer


def load_checkpoint_actor(model_dir, device, best=False):
    """The policy (SAC actor, or learner) and normalizer of a
    checkpoint written by `train` (latest, or the best evaluation). Returns
    (config, policy, normalizer)."""
    config = cfg_util.load_config(os.path.join(model_dir, "config.yaml"))
    ckpt = cb.Checkpointer(model_dir)
    bundle = ckpt.restore_best(device) if best else ckpt.restore(device=device)
    policy = _policy_for(config, device)
    if isinstance(policy, SACActor):
        policy.load_state_dict(bundle["algo_state"]["actor"])
        policy.eval()
    else:
        policy.load_state_dict(bundle["algo_state"])
    rms = lambda d: RunningMeanStd(mean=d["mean"], var=d["var"], count=d["count"])
    normalizer = NormalizerState(obs_rms=rms(bundle["obs_rms"]), ret_rms=rms(bundle["ret_rms"]),
                                 returns=torch.zeros(0, device=device))
    return config, policy, normalizer


def run(args):
    device = _device(args.device)
    if bool(args.npz) == bool(args.model):
        raise SystemExit("run needs exactly one of --model <dir> or --npz <dir>")
    set_precision()
    if args.npz:
        config, actor, normalizer = load_bundle_actor(args.npz, device)
    else:
        config, actor, normalizer = load_checkpoint_actor(args.model, device, best=args.best)
    evaluator = Evaluator(config, device)
    initial_states, n_episodes = None, args.episodes or 100
    if args.scenes:
        initial_states = load_scenes(args.scenes, device)
        n_episodes = int(initial_states.episode_step.shape[0])
        if args.episodes not in (None, n_episodes):
            raise SystemExit(f"{args.scenes} holds {n_episodes} scenes, not {args.episodes}")
    t0 = time.perf_counter()
    res = evaluator.evaluate(actor, normalizer, n_episodes=n_episodes, validate=not args.test,
                             stochastic=args.stochastic, initial_states=initial_states)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    print("{:<13}{:>7.2f}".format("Mean reward:", res["mean_return"]))
    print("{:<13}{:>7.2f}".format("Mean steps:", res["mean_length"]))
    print("{:<13}{:>7.2f}".format("Mean success rate:", res["success_rate"]))
    print("{:<13}{:>7.2f}".format("Mean objects cleared:", res["mean_cleared"]))
    print("{:<13}{:>7.2f}".format("Wall seconds:", wall))
    res["wall_seconds"] = wall
    return res


def parse_args(argv=None):
    """The parsed command line (`argv`, default sys.argv[1:]), kept as
    `args.argv`."""
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(required=True)

    tp = sub.add_parser("train", help="train SAC, DQN, BDQ, DDPG, PPO or TRPO from a config")
    tp.add_argument("--config", type=str, required=True)
    tp.add_argument("--algo", type=str, required=True)
    tp.add_argument("--model_dir", type=str, required=True)
    tp.add_argument("--load_dir", type=str,
                    help="resume from the newest checkpoint and ring snapshot of this "
                         "directory (written by `train`; may equal --model_dir)")
    tp.add_argument("--timestep", type=str)
    tp.add_argument("--seed", type=int, default=0)
    tp.add_argument("-s", "--simple", action="store_true")
    tp.add_argument("-sh", "--shaped", action="store_true")
    tp.add_argument("-tf", "--timefeature", action="store_true")
    tp.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    tp.set_defaults(func=train)

    rp = sub.add_parser("run", help="evaluate a checkpoint or a committed policy bundle")
    rp.add_argument("--model", type=str, help="model dir written by `train`")
    rp.add_argument("--npz", type=str, help="policy bundle dir (policy.npz + config.yaml)")
    rp.add_argument("-b", "--best", action="store_true",
                    help="evaluate the best-eval checkpoint instead of the latest")
    rp.add_argument("-t", "--test", action="store_true")
    rp.add_argument("-s", "--stochastic", action="store_true")
    rp.add_argument("--episodes", type=int,
                    help="episodes of the protocol (default 100; with --scenes, one per scene)")
    rp.add_argument("--scenes", type=str,
                    help="npz of env states under scene.* to start the episodes from")
    rp.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    rp.set_defaults(func=run)
    args = parser.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    return args


def main(argv=None):
    args = parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
