"""Data-parallel training over `torch.distributed` (port of
deep_rl_grasping_tpu/parallel/train_dp.py).

The JAX package splits the global env batch over a mesh's 'env' axis with
shard_map: every device runs the same per-shard trainer with its own envs
and replay, gradients are pmean'd so the learner stays replicated, and the
curriculum window folds every shard's finished episodes (grasp_env.py:
633-638). Here one process per rank does the same:

* `DataParallel` holds one process group's collectives on the rank's
  device. The gradient mean of one optimizer step is one all_reduce of the
  flattened gradients, a sum divided by the world size (gloo has no AVG;
  x / 1 is exact, so at world 1 the update is the single-device update bit
  for bit). The rank-order gather is an all_reduce of a zero-filled
  (world, n) tensor in which each rank fills its own row: gloo cannot
  all_gather CUDA tensors, and this is one code path for both backends.
* `ShardedTrainer` is a per-rank `Trainer` with num_envs // world envs, a
  full-size replay, generators seeded from the seed and the rank, the
  learner's optimizers fed the rank mean of the gradients, and the
  curriculum fed the gathered masks. Rank 0's learner is broadcast at the
  start (and, through `broadcast_learner`, after a resume). The JAX
  package builds each device's learner from that device's own key
  (`_init_local` below its :54, trainer.py:332-343), so its replicas
  differ from the start, against its docstring; the port follows the
  docstring. The observation normalizer stays per rank, as in the JAX
  package.
* Process groups (`process_group`): NCCL with one process per visible card
  (rank r on cuda:r), gloo on the CPU and for several ranks on one card.
  `start` spawns ranks with the spawn start method (CUDA cannot fork);
  `launch_train` runs the `train` entry point on `world` ranks, building
  the kernels in the parent first (two ranks would race nvcc into the same
  build directory), in this process when world is 1.

The training loop itself (rank 0 writes checkpoints and logs, frames count
all ranks, the stop flag is agreed after every chunk) is
training/train.py's `run_training`.
"""

from __future__ import annotations

import contextlib
import copy
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from deep_rl_grasping_tpu_torch.training.trainer import Trainer
from deep_rl_grasping_tpu_torch.utils import config as cfg_util


class DataParallel:
    """The collectives of one process group, on `device` (this rank's)."""

    def __init__(self, device, group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)

    def _sum_(self, t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def mean(self, tensors):
        """The mean over ranks of a list of floating tensors of one dtype on
        the device, as new tensors: one all_reduce of their concatenation."""
        flat = self._sum_(torch.cat([t.reshape(-1) for t in tensors]))
        flat /= self.world
        return [v.view_as(t) for t, v in zip(tensors, flat.split([t.numel() for t in tensors]))]

    def sum(self, t):
        """The sum over ranks of `t` (a new tensor)."""
        return self._sum_(t.clone())

    def gather(self, x):
        """Every rank's `x` (n, ...) concatenated in rank order:
        (world * n, ...)."""
        buf = x.new_zeros((self.world,) + tuple(x.shape))
        buf[self.rank] = x
        return self._sum_(buf).reshape((-1,) + tuple(x.shape[1:]))

    def any(self, flag):
        """Whether `flag` holds on any rank (a host sync)."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(self._sum_(t)[0] > 0)

    def broadcast_(self, tensors, src=0):
        """Overwrite `tensors` (any devices and dtypes) with rank `src`'s
        values: one broadcast per dtype, through the device."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1).to(self.device) for t in ts])
            dist.broadcast(flat, src, group=self.group)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def broadcast_learner(dp: DataParallel, algo):
    """Give every rank rank 0's learner: parameters, target networks,
    optimizer moments and step counts (its `state_dict`)."""
    sd = algo.state_dict()
    dp.broadcast_(list(_tensors(sd)))
    algo.load_state_dict(sd)


class ShardedTrainer(Trainer):
    """One rank's trainer (see the module docstring). `num_envs` is the
    rank's env count; `total_envs` the config's global one."""

    def __init__(self, config, dp: DataParallel, algo="SAC", seed=0):
        cfg = copy.deepcopy(cfg_util.load_config(config))
        total = int(cfg["tpu"].get("num_envs", 128))
        if total % dp.world:
            raise ValueError(f"tpu.num_envs {total} must divide evenly over {dp.world} ranks")
        cfg["tpu"]["num_envs"] = total // dp.world
        super().__init__(cfg, algo=algo, device=dp.device, seed=seed, rank=dp.rank)
        self.dp = dp
        self.total_envs = total
        self.benv.dp = dp
        self.algo.grad_mean = self._grad_mean
        self.demo_local = None  # (episodes, successes) of this rank's last seeding
        broadcast_learner(dp, self.algo)

    def _grad_mean(self, grads):
        t0 = self.clock.mark()
        out = self.dp.mean(list(grads))
        self.clock.add("allreduce", t0, self.clock.mark())
        return out

    def seed_demos(self, state, n_frames):
        """`n_frames // world` expert frames on each rank; the episode
        counts are summed over ranks (train_dp.py:107-128)."""
        state, n_done, n_succ = super().seed_demos(state, max(n_frames // self.dp.world, 1))
        self.demo_local = (n_done, n_succ)
        counts = self.dp.sum(torch.tensor([n_done, n_succ], dtype=torch.float64,
                                          device=self.device))
        return state, float(counts[0]), float(counts[1])

    def train_chunk(self, state, n_steps):
        """`Trainer.train_chunk`, its metrics averaged over ranks
        (train_dp.py:90)."""
        state, metrics = super().train_chunk(state, n_steps)
        keys = list(metrics)
        mean = self.dp.mean([torch.stack([metrics[k].to(torch.float32) for k in keys])])[0]
        return state, dict(zip(keys, mean))


def make_sharded_trainer(config, dp: DataParallel, algo="SAC", seed=0):
    """This rank's `ShardedTrainer` of the config's global env batch."""
    return ShardedTrainer(config, dp, algo=algo, seed=seed)


# ---------------------------------------------------------------------- processes

@contextlib.contextmanager
def process_group(backend, world, rank, store_dir):
    """The default process group of `world` ranks, met through a file store
    in `store_dir` (fresh for each group); destroyed on exit."""
    dist.init_process_group(backend, init_method="file://" + os.path.join(store_dir, "store"),
                            world_size=world, rank=rank)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _entry(rank, fn, world, backend, devices, tmp, args):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with process_group(backend, world, rank, tmp):
        result = fn(rank, device, *args)
    torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))


class Ranks:
    """Rank processes started by `start`: their `pids`, and `join`, which
    returns what each rank's function returned, in rank order."""

    def __init__(self, context, tmp, world):
        self.context, self.tmp, self.world = context, tmp, world

    @property
    def pids(self):
        return self.context.pids()

    def join(self, timeout=None):
        """Wait for every rank (at most `timeout` seconds: then the ranks are
        killed and TimeoutError raised). A rank that raised terminates the
        others and its error is raised here."""
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not self.context.join(timeout=5.0):
                if deadline is not None and time.monotonic() > deadline:
                    for p in self.context.processes:
                        if p.is_alive():
                            p.kill()
                    raise TimeoutError(f"ranks still running after {timeout} s")
            return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"), weights_only=True)
                    for r in range(self.world)]
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)


def start(fn, world, backend, devices, *args):
    """Spawn `world` processes, rank r on `devices[r]`, each in the default
    process group of `backend`, running `fn(rank, device, *args)`; `fn` must
    be importable by name and its result storable by `torch.save`."""
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got {devices}")
    tmp = tempfile.mkdtemp(prefix="train_dp_")
    context = torch.multiprocessing.start_processes(
        _entry, args=(fn, world, backend, list(devices), tmp, args), nprocs=world, join=False,
        start_method="spawn")
    return Ranks(context, tmp, world)


def rank_main(rank, device, argv):
    """What each rank of `launch_train` runs: `train.train_rank` on `argv`."""
    import logging

    from deep_rl_grasping_tpu_torch.training import train

    if not logging.getLogger().handlers:  # a spawned rank: rank 0 logs, the others warn
        logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                            format=f"%(asctime)s rank {rank} %(message)s")
    return train.train_rank(train.parse_args(argv), DataParallel(device))


def launch_train(argv, world, backend, devices, timeout=None):
    """The `train` entry point (`argv` as `train.main` takes it) on `world`
    ranks; returns each rank's `train.train_rank` summary, in rank order.
    World 1 runs in this process."""
    if any(torch.device(d).type == "cuda" for d in devices):
        from deep_rl_grasping_tpu_torch.ops import build

        build.library()
    if world > 1:
        return start(rank_main, world, backend, devices, list(argv)).join(timeout)
    device = torch.device(devices[0])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tmp = tempfile.mkdtemp(prefix="train_dp_")
    try:
        with process_group(backend, 1, 0, tmp):
            return [rank_main(0, device, list(argv))]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    """python -m deep_rl_grasping_tpu_torch.parallel.train_dp --devices D0,D1,...
    -- train --config ... (the `train` command line): `launch_train` on one
    gloo rank per listed device, for example two ranks on one card
    (`--devices cuda:0,cuda:0`) or on the CPU. Runs on several cards go
    through `train`, which takes NCCL. Prints rank 0's result as one JSON
    line."""
    import argparse
    import json
    import logging

    p = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    p.add_argument("--devices", required=True, help="comma-separated, one device per rank")
    p.add_argument("train_argv", nargs=argparse.REMAINDER,
                   help="-- then the train command line")
    args = p.parse_args(argv)
    train_argv = args.train_argv[1:] if args.train_argv[:1] == ["--"] else args.train_argv
    devices = args.devices.split(",")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ranks = launch_train(train_argv, len(devices), "gloo", devices)
    result = dict(ranks[0]["result"], devices=devices, backend="gloo")
    print(json.dumps(result, default=str), flush=True)
    return result


if __name__ == "__main__":
    main()
