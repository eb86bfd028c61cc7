"""Logging, checkpoints and timing (port of
deep_rl_grasping_tpu/training/callbacks.py).

* `MonitorLogger`    - the Monitor CSV (r, l, t, s): one row per episode.
* `ScalarLogger`     - logs.csv-style rows of training scalars.
* `CurriculumLogger` - curriculum_steps.csv: one line per lambda increment.
* `Checkpointer`     - `torch.save` of the checkpoint payload under
                       <model_dir>/logs (newest 3 kept) and of the best
                       evaluation under <model_dir>/best_model, in place of
                       Orbax.
* `TrainingTimer`    - rolling env frames per second.

The replay-ring checkpointer (`RingCheckpointer`) is not ported yet. The
monitor writes through buffered Python IO (the JAX package's fallback when
its native CSV writer is not built).
"""

from __future__ import annotations

import csv
import glob
import json
import os
import re
import time

import numpy as np
import torch


class MonitorLogger:
    """Episode CSV in the reference Monitor format, one row per episode."""

    def __init__(self, model_dir, filename="log_file.monitor.csv"):
        os.makedirs(model_dir, exist_ok=True)
        self._t0 = time.time()
        self._file = open(os.path.join(model_dir, filename), "w", newline="")
        header = json.dumps({"t_start": self._t0, "env_id": "gripper-env-v0"})
        self._file.write(f"#{header}\nr,l,t,s\n")
        self._file.flush()

    def log_episodes(self, rows):
        """rows: (N, 3) array-like of (return, length, success)."""
        t = time.time() - self._t0
        lines = "".join(f"{r:.2f},{l:.0f},{t:.1f},{s:.0f}\n" for r, l, s in rows)
        if lines:
            self._file.write(lines)
            self._file.flush()

    def close(self):
        self._file.close()


class ScalarLogger:
    """CSV of training scalars; the columns are those of the first row."""

    def __init__(self, model_dir, filename="logs.csv"):
        os.makedirs(model_dir, exist_ok=True)
        self._path = os.path.join(model_dir, filename)
        self._file = None
        self._fields = None

    def log(self, step, scalars):
        row = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
        if self._file is None:
            self._fields = list(row)
            self._file = open(self._path, "w", newline="")
            self._csv = csv.DictWriter(self._file, fieldnames=self._fields)
            self._csv.writeheader()
        self._csv.writerow({k: row.get(k, "") for k in self._fields})
        self._file.flush()

    def close(self):
        if self._file:
            self._file.close()


class CurriculumLogger:
    """curriculum_steps.csv (curriculum.py:51-54)."""

    def __init__(self, model_dir):
        os.makedirs(model_dir, exist_ok=True)
        self._path = os.path.join(model_dir, "curriculum_steps.csv")
        self._last_iteration = 0

    def log(self, policy_iteration, lam):
        policy_iteration = int(policy_iteration)
        if policy_iteration != self._last_iteration:
            with open(self._path, "a") as f:
                f.write(f"{policy_iteration} {float(lam):.6f}\n")
            self._last_iteration = policy_iteration


_CKPT = re.compile(r"^ckpt_(\d+)\.pt$")


class Checkpointer:
    """Checkpoints of a payload of tensors, dicts and numbers: `torch.save`
    files named by frame count, the newest `max_to_keep` kept, plus the
    best evaluation in best_model/ (one kept)."""

    def __init__(self, model_dir, max_to_keep=3):
        self._dir = os.path.abspath(os.path.join(model_dir, "logs"))
        self._best_dir = os.path.abspath(os.path.join(model_dir, "best_model"))
        os.makedirs(self._dir, exist_ok=True)
        os.makedirs(self._best_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = -np.inf

    @staticmethod
    def _steps(directory):
        steps = []
        for path in glob.glob(os.path.join(directory, "ckpt_*.pt")):
            m = _CKPT.match(os.path.basename(path))
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    @staticmethod
    def _write(directory, step, payload, keep):
        path = os.path.join(directory, f"ckpt_{int(step)}.pt")
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in Checkpointer._steps(directory)[:-keep]:
            os.remove(os.path.join(directory, f"ckpt_{old}.pt"))

    def save(self, step, payload):
        self._write(self._dir, step, payload, self.max_to_keep)

    def save_best(self, step, payload, metric):
        """Save when `metric` beats the best so far; returns whether it did."""
        if metric > self.best_metric:
            self.best_metric = float(metric)
            self._write(self._best_dir, step, payload, 1)
            return True
        return False

    def latest_step(self):
        steps = self._steps(self._dir)
        return steps[-1] if steps else None

    @staticmethod
    def _load(directory, step, device):
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        return torch.load(os.path.join(directory, f"ckpt_{int(step)}.pt"),
                          map_location=device, weights_only=True)

    def restore(self, step=None, device="cpu"):
        return self._load(self._dir, self.latest_step() if step is None else step, device)

    def restore_best(self, device="cpu"):
        steps = self._steps(self._best_dir)
        return self._load(self._best_dir, steps[-1] if steps else None, device)


class TrainingTimer:
    """Rolling env frames per second over the last `window` ticks."""

    def __init__(self, window=20):
        self._t = None
        self._history = []
        self._window = window

    def tick(self, frames):
        now = time.perf_counter()
        if self._t is not None:
            self._history.append(frames / max(now - self._t, 1e-9))
            self._history = self._history[-self._window:]
        self._t = now

    @property
    def steps_per_s(self):
        return float(np.mean(self._history)) if self._history else 0.0
