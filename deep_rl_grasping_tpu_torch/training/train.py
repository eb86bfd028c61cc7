"""Command line entry point of the port (counterpart of
deep_rl_grasping_tpu/training/train.py).

    python -m deep_rl_grasping_tpu_torch.training.train train \
        --config configs/sac_rgbd_flagship.yaml --algo SAC --model_dir <dir> \
        [--timestep N] [--seed S] [--device cuda|cpu]
    python -m deep_rl_grasping_tpu_torch.training.train run \
        --model <dir> [-b] | --npz trained/sac_full_flagship_r5c \
        [--episodes N] [-t] [--stochastic] [--device cuda|cpu]

`train` is the single-device off-policy (SAC) branch of train.py:78-473:
demo seeding and periodic refresh, the chunk loop, the monitor, scalar,
curriculum and TensorBoard logs, `stop_at_sr`, the q-tripwire rollback,
the eval cadence (protocol eval plus the eval at the training lambda),
checkpoints and the best model, SIGTERM handling and the `done:` /
`stopped:` marker. `run` evaluates a checkpoint this port wrote (`--model`,
latest or `-b` best) or a committed SAC policy bundle (`--npz`) on the
100-episode protocol (train.py:474).

Both run on the card unless `--device cpu` is given; with no card and no
`--device cpu` they stop with an error instead of falling back.
`--load_dir` resume, replay-ring snapshots and the sharded path are not
ported yet.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import signal
import time

import torch

from deep_rl_grasping_tpu_torch.algos.normalize import NormalizerState, RunningMeanStd
from deep_rl_grasping_tpu_torch.envs.actuator import ActuatorSpec
from deep_rl_grasping_tpu_torch.models.networks import SACActor
from deep_rl_grasping_tpu_torch.training import callbacks as cb
from deep_rl_grasping_tpu_torch.training.trainer import Evaluator, Trainer
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils, policy_io
from deep_rl_grasping_tpu_torch.utils.tb_events import TensorBoardWriter

log = logging.getLogger(__name__)
# chunks in a row at lambda 1 with the success rate at tpu.stop_at_sr before
# an early stop (the JAX package's tpu.stop_at_patience default; no config
# sets it)
STOP_PATIENCE = 50


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


def _rms(r: RunningMeanStd):
    return {"mean": r.mean, "var": r.var, "count": r.count}


def _bundle(trainer: Trainer, state):
    """Checkpoint payload (train.py:64-76): learner, normalizer moments and
    curriculum state. The per-env running returns are not saved."""
    cur = state.curriculum
    return {
        "algo_state": trainer.algo.state_dict(),
        "obs_rms": _rms(state.normalizer.obs_rms),
        "ret_rms": _rms(state.normalizer.ret_rms),
        "curriculum": {f: getattr(cur, f) for f in
                       ("lam", "ring", "ptr", "filled", "sr_mean", "policy_iteration")},
    }


def train(args):
    device = _device(args.device)
    set_precision()
    config = cfg_util.load_config(args.config)
    algo = args.algo.upper()
    if algo != "SAC":
        raise SystemExit("the port trains SAC only")
    model_dir = args.model_dir
    os.makedirs(os.path.join(model_dir, "best_model"), exist_ok=True)

    # CLI overrides (train_stable_baselines.py:34-50)
    if args.simple:
        config["simplified"] = True
    if args.shaped:
        config["reward"]["shaped"] = True
    if args.timestep:
        config.setdefault(algo, {})["total_timesteps"] = int(args.timestep)
    if args.timefeature:
        config["time_feature"] = True
    config["robot"]["discrete"] = False
    config["algorithm"] = algo.lower()
    io_utils.save_yaml(config, os.path.join(model_dir, "config.yaml"))
    io_utils.save_yaml(config, os.path.join(model_dir, "best_model", "config.yaml"))

    tpu = config.get("tpu", {})
    total_timesteps = int(config.get(algo, {}).get("total_timesteps", 1_000_000))
    eval_freq = int(tpu.get("eval_freq", 50_000))
    checkpoint_freq = int(tpu.get("checkpoint_freq", 25_000))
    chunk_steps = max(int(tpu.get("chunk_steps", 20)), 1)

    t_start = time.perf_counter()
    trainer = Trainer(config, algo=algo, device=device, seed=args.seed)
    state = trainer.init_state()
    frames_per_chunk = chunk_steps * trainer.num_envs

    demo_frames = int(tpu.get("demo_frames", 0))
    if demo_frames > 0:
        state, n_done, n_succ = trainer.seed_demos(state, demo_frames)
        log.info("seeded %d demo frames: %d episodes, %.1f%% success", demo_frames,
                 int(n_done), 100.0 * n_succ / max(n_done, 1.0))

    monitor = cb.MonitorLogger(model_dir)
    scalars = cb.ScalarLogger(model_dir)
    tb = TensorBoardWriter(os.path.join(model_dir, "tb"))
    eval_log = cb.ScalarLogger(model_dir, filename="eval_logs.csv")
    curr_log = cb.CurriculumLogger(model_dir)
    ckpt = cb.Checkpointer(model_dir)
    timer = cb.TrainingTimer()

    # Divergence tripwire: q_target_mean outside a band 2% inside SAC.q_clip
    # rolls the learner back to the last checkpoint.
    q_band = None
    qc = config.get("SAC", {}).get("q_clip")
    if qc:
        margin = 0.02 * (float(qc[1]) - float(qc[0]))
        q_band = [float(qc[0]) + margin, float(qc[1]) - margin]
    last_rollback = -10 ** 9

    demo_refresh_every = int(tpu.get("demo_refresh_every", 0))
    demo_refresh_frames = int(tpu.get("demo_refresh_frames", 0))
    last_demo = 0
    stop_at_sr = tpu.get("stop_at_sr")
    stop_streak = 0
    solved = False

    log.info("training %s for %d frames (%d envs) on %s", algo, total_timesteps,
             trainer.num_envs, device)
    frames = last_eval = last_ckpt = 0
    drained = 0
    row, res = {}, {}
    term_requested = []
    prev_handler = signal.signal(signal.SIGTERM, lambda *_: term_requested.append(True))
    try:
        while frames < total_timesteps:
            if term_requested:
                log.info("SIGTERM received; saving and exiting at %d frames", frames)
                break
            state, metrics = trainer.train_chunk(state, chunk_steps)
            frames = state.global_step
            timer.tick(frames_per_chunk)

            # one monitor row per episode finished in this chunk
            ring_n, R = int(state.ep_ring_n), state.ep_ring.shape[0]
            new = min(ring_n - drained, R)
            if new > 0:
                idx = torch.arange(ring_n - new, ring_n, device=state.ep_ring.device) % R
                monitor.log_episodes(state.ep_ring[idx].cpu().tolist())
            drained = ring_n
            cur = state.curriculum
            sr, lam = float(cur.sr_mean), float(cur.lam)
            row = dict(success_rate=sr, curriculum_lambda=lam, steps_per_s=timer.steps_per_s,
                       **{k: float(v) for k, v in metrics.items()})
            scalars.log(frames, row)
            tb.add_scalars(frames, row)
            curr_log.log(int(cur.policy_iteration), lam)
            log.info("frames %d  sr %.3f  lambda %.2f  %.0f steps/s", frames, sr, lam,
                     timer.steps_per_s)

            if stop_at_sr is not None:
                at_target = lam >= 1.0 and sr >= float(stop_at_sr)
                stop_streak = stop_streak + 1 if at_target else 0
                if stop_streak >= STOP_PATIENCE:
                    log.info("early stop: sr %.3f >= %.3f at lambda=1.0 for %d consecutive "
                             "chunks (%d frames)", sr, float(stop_at_sr), STOP_PATIENCE, frames)
                    solved = True
                    break

            qm = row["q_target_mean"]
            if (q_band and math.isfinite(qm) and last_ckpt > 0
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
                ckpt.save(frames, _bundle(trainer, state))
                last_ckpt = frames
            if frames - last_eval >= eval_freq:
                actor, norm = trainer.algo.actor, state.normalizer
                res = trainer.evaluate(actor, norm)
                log.info("eval @ %d: %s", frames, res)
                # second eval at the training lambda while the curriculum ramps
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
                last_eval = frames
    except KeyboardInterrupt:
        log.info("interrupted; saving the model")
    finally:
        signal.signal(signal.SIGTERM, prev_handler)

    ckpt.save(max(frames, 1), _bundle(trainer, state))
    monitor.close()
    scalars.close()
    eval_log.close()
    tb.close()
    done = frames >= total_timesteps or solved
    if done:
        log.info("done: %d frames", frames)
    else:
        log.info("stopped: %d frames (target %d)", frames, total_timesteps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cur = state.curriculum
    return dict(frames=frames, done=done, wall_seconds=time.perf_counter() - t_start,
                curriculum_lambda=float(cur.lam), success_rate=float(cur.sr_mean),
                episodes=int(state.ep_ring_n), metrics=row, eval=res,
                updates=trainer.algo.step, phase_seconds=trainer.clock.totals(),
                checkpoint_step=ckpt.latest_step())


def _actor_for(config, obs_shape):
    layers = tuple(config.get("SAC", {}).get("layers", [64, 64]))
    action_dim = ActuatorSpec.from_config(config).action_dim
    return SACActor(obs_shape, action_dim, layers, image_obs=True)


def _obs_shape(config):
    info = io_utils.load_yaml(cfg_util.resolve_path(config["sensor"]["camera_info"]))
    return (int(info["height"]), int(info["width"]), 5 if config.get("full_observation") else 2)


def load_bundle_actor(model_dir, device):
    """Build the SAC actor for a committed bundle's config and load its
    weights. Returns (config, actor, normalizer)."""
    config = cfg_util.load_config(os.path.join(model_dir, "config.yaml"))
    algo = config.get("algorithm", "sac").upper()
    if algo != "SAC":
        raise SystemExit(f"the port evaluates SAC bundles only (bundle algo: {algo})")
    if not (config.get("depth_observation") or config.get("full_observation")):
        raise SystemExit("the port evaluates image-observation bundles only")
    actor = _actor_for(config, _obs_shape(config))
    actor, normalizer, _meta = policy_io.load_policy(model_dir, actor, device)
    actor.eval()
    return config, actor, normalizer


def load_checkpoint_actor(model_dir, device, best=False):
    """The actor and normalizer of a checkpoint written by `train` (latest,
    or the best evaluation). Returns (config, actor, normalizer)."""
    config = cfg_util.load_config(os.path.join(model_dir, "config.yaml"))
    if config.get("algorithm", "sac").upper() != "SAC":
        raise SystemExit("the port evaluates SAC checkpoints only")
    ckpt = cb.Checkpointer(model_dir)
    bundle = ckpt.restore_best(device) if best else ckpt.restore(device=device)
    actor = _actor_for(config, _obs_shape(config)).to(device)
    actor.load_state_dict(bundle["algo_state"]["actor"])
    actor.eval()
    rms = lambda d: RunningMeanStd(mean=d["mean"], var=d["var"], count=d["count"])
    normalizer = NormalizerState(obs_rms=rms(bundle["obs_rms"]), ret_rms=rms(bundle["ret_rms"]),
                                 returns=torch.zeros(0, device=device))
    return config, actor, normalizer


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
    t0 = time.perf_counter()
    res = evaluator.evaluate(actor, normalizer, n_episodes=args.episodes,
                             validate=not args.test, stochastic=args.stochastic)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    print("{:<13}{:>7.2f}".format("Mean reward:", res["mean_return"]))
    print("{:<13}{:>7.2f}".format("Mean steps:", res["mean_length"]))
    print("{:<13}{:>7.2f}".format("Mean success rate:", res["success_rate"]))
    print("{:<13}{:>7.2f}".format("Wall seconds:", wall))
    res["wall_seconds"] = wall
    return res


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(required=True)

    tp = sub.add_parser("train", help="train SAC from a config")
    tp.add_argument("--config", type=str, required=True)
    tp.add_argument("--algo", type=str, required=True)
    tp.add_argument("--model_dir", type=str, required=True)
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
    rp.add_argument("--episodes", type=int, default=100)
    rp.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    rp.set_defaults(func=run)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
