"""Device-resident replay with n-step returns, uniform or prioritized
(port of deep_rl_grasping_tpu/algos/replay.py: `create` :43, `insert` :68,
`_valid_range` :84, `_nstep_gather` :90, `sample` :109,
`sample_prioritized` :155, `update_priorities` :194, `snapshot` :197,
`restore_snapshot` :226).

Observations are stored once, as flat bfloat16 rows (C, prod(obs_shape)) in
the JAX package's NHWC order; the next observation of frame t is the row one
env batch (`batch_stride`) later. For a terminal frame that row belongs to
the auto-reset episode, and the n-step gather stops at the terminal, so it
is never bootstrapped from. Capacity is rounded down to a multiple of the
insert width. The port writes the ring in place, and keeps the write
pointer and the fill count as Python integers: every insert has the same
width, so both are known without reading the device.

Prioritized replay (Schaul et al. 2016, proportional): every row has a
priority; a new row enters at the ring's largest priority (1 in an empty
ring). `sample_prioritized` draws with replacement from the sampleable
rows with probability p^alpha / sum p^alpha (the dense categorical of the
JAX package, here `torch.multinomial` on the learner's generator) and
weights each drawn row by (N P(i))^-beta / max w; `update_priorities` sets
the drawn rows to |TD| + 1e-6. Discrete actions are stored as integers
(the trainer creates the ring with an int32 action column).

A ring snapshot holds the newest rows of the ring in ring order, with
their priorities, for a checkpoint that a resumed run restores before it
collects again (training/train.py). It is gathered on the device and
copied to the host once per column.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ReplayBuffer:
    obs: torch.Tensor     # (C, prod(obs_shape)) storage dtype
    action: torch.Tensor  # (C, *act_shape)
    reward: torch.Tensor  # (C,) float32
    done: torch.Tensor    # (C,) bool
    priority: torch.Tensor  # (C,) float32 (1 while uniform)
    ptr: int              # next write slot
    size: int             # frames written, saturating at capacity
    batch_stride: int
    capacity: int
    obs_shape: tuple


def create(capacity, obs_shape, action_shape, batch_stride, obs_dtype=torch.bfloat16,
           action_dtype=torch.float32, device="cpu") -> ReplayBuffer:
    capacity = (int(capacity) // batch_stride) * batch_stride
    if capacity <= 0:
        raise ValueError(f"replay capacity must hold at least one batch of {batch_stride}")
    return ReplayBuffer(
        obs=torch.zeros((capacity, int(np.prod(obs_shape))), dtype=obs_dtype, device=device),
        action=torch.zeros((capacity,) + tuple(action_shape), dtype=action_dtype, device=device),
        reward=torch.zeros(capacity, device=device),
        done=torch.zeros(capacity, dtype=torch.bool, device=device),
        priority=torch.ones(capacity, device=device),
        ptr=0, size=0, batch_stride=int(batch_stride), capacity=capacity,
        obs_shape=tuple(obs_shape))


def insert(buf: ReplayBuffer, obs, action, reward, done) -> ReplayBuffer:
    """Write one env batch (batch_stride rows) at the write pointer, at the
    ring's largest priority."""
    B, p = buf.batch_stride, buf.ptr
    buf.priority[p:p + B] = buf.priority.max() if buf.size > 0 else 1.0
    buf.obs[p:p + B] = obs.reshape(B, -1).to(buf.obs.dtype)
    buf.action[p:p + B] = action.to(buf.action.dtype)
    buf.reward[p:p + B] = reward
    buf.done[p:p + B] = done
    buf.ptr = (p + B) % buf.capacity
    buf.size = min(buf.size + B, buf.capacity)
    return buf


def _valid_range(buf: ReplayBuffer, n_step=1) -> int:
    """Sampleable frames: written, with their n_step successors written."""
    return max(buf.size - n_step * buf.batch_stride, 0)


def _nstep_gather(buf: ReplayBuffer, idx, n_step, gamma):
    """n-step return sum_i gamma^i r_{t+i}, cut after the first terminal;
    done = the episode ended inside the window; next index t + n; bootstrap
    discount gamma^n, or 0 after a terminal."""
    acc_r = torch.zeros(idx.shape, device=idx.device)
    stop = torch.zeros(idx.shape, dtype=torch.bool, device=idx.device)
    for i in range(n_step):
        idx_i = (idx + i * buf.batch_stride) % buf.capacity
        acc_r = acc_r + (gamma ** i) * buf.reward[idx_i] * (~stop)
        stop = stop | buf.done[idx_i]
    nxt = (idx + n_step * buf.batch_stride) % buf.capacity
    discount = (gamma ** n_step) * (~stop).to(torch.float32)
    return acc_r, stop, nxt, discount


def draw_offsets(buf: ReplayBuffer, gen, batch_size, n_step=1, recent_batch=0,
                 recent_window=0):
    """Oldest-first window offsets of a uniform sample: `recent_batch` of
    them from the newest `recent_window` sampleable frames, the rest from
    all of them (replay.py:109-137)."""
    n = _valid_range(buf, n_step)
    dev = buf.reward.device
    if recent_batch > 0 and recent_window > 0:
        offs_all = torch.randint(0, max(n, 1), (batch_size - recent_batch,), generator=gen,
                                 device=dev)
        lo = max(n - recent_window, 0)
        offs_rec = lo + torch.randint(0, max(n - lo, 1), (recent_batch,), generator=gen,
                                      device=dev)
        return torch.cat([offs_all, offs_rec])
    return torch.randint(0, max(n, 1), (batch_size,), generator=gen, device=dev)


def gather(buf: ReplayBuffer, offs, n_step=1, gamma=0.99):
    """The transitions at window offsets `offs` (slot i of the window is
    ring index (ptr - size + i) mod C)."""
    idx = (buf.ptr - buf.size + offs) % buf.capacity
    reward, done, nxt, discount = _nstep_gather(buf, idx, n_step, gamma)
    img = (offs.shape[0],) + buf.obs_shape
    return dict(
        obs=buf.obs[idx].to(torch.float32).reshape(img),
        action=buf.action[idx],
        reward=reward,
        done=done,
        discount=discount,
        next_obs=buf.obs[nxt].to(torch.float32).reshape(img),
        idx=idx,
        weight=torch.ones(offs.shape[0], device=offs.device),
    )


def sample(buf: ReplayBuffer, gen, batch_size, n_step=1, gamma=0.99, recent_batch=0,
           recent_window=0):
    """Uniform sample of n-step transitions, drawn with `gen`."""
    offs = draw_offsets(buf, gen, batch_size, n_step, recent_batch, recent_window)
    return gather(buf, offs, n_step, gamma)


def probabilities(buf: ReplayBuffer, alpha=0.6, n_step=1):
    """Per ring row, the probability that one prioritized draw picks it:
    p^alpha over the sampleable rows' sum, 0 for the rest (C,)."""
    n = _valid_range(buf, n_step)
    ring = torch.arange(buf.capacity, device=buf.priority.device)
    valid = torch.remainder(ring - (buf.ptr - buf.size), buf.capacity) < n
    p = torch.where(valid, torch.clamp(buf.priority, min=1e-12) ** alpha, 0.0)
    return p / torch.clamp(p.sum(), min=1e-12)


def _weights(probs, n, beta):
    w = (max(n, 1) * probs) ** (-beta)
    return w / torch.clamp(w.max(), min=1e-12)


def importance_weights(buf: ReplayBuffer, idx, alpha=0.6, beta=0.4, n_step=1):
    """Importance weights (N P(i))^-beta / max w of the ring rows `idx`,
    N the number of sampleable rows, and their probabilities P(i)."""
    probs = probabilities(buf, alpha, n_step)[idx]
    return _weights(probs, _valid_range(buf, n_step), beta), probs


def sample_prioritized(buf: ReplayBuffer, gen, batch_size, alpha=0.6, beta=0.4, n_step=1,
                       gamma=0.99):
    """Proportional prioritized sample of n-step transitions, with
    replacement, drawn with `gen`; `weight` holds the importance weights."""
    probs = probabilities(buf, alpha, n_step)
    idx = torch.multinomial(probs, batch_size, replacement=True, generator=gen)
    batch = gather(buf, torch.remainder(idx - (buf.ptr - buf.size), buf.capacity), n_step, gamma)
    batch["weight"] = _weights(probs[idx], _valid_range(buf, n_step), beta)
    return batch


def update_priorities(buf: ReplayBuffer, idx, td_errors, eps=1e-6) -> ReplayBuffer:
    """Set the priorities of ring rows `idx` to |TD| + eps (a row drawn
    twice keeps one of its two values)."""
    buf.priority[idx] = torch.abs(td_errors).to(buf.priority.dtype) + eps
    return buf


def snapshot(buf: ReplayBuffer, rows) -> dict:
    """The newest `rows` frames in ring order (`rows` capped at the
    capacity and rounded down to the batch stride), as host tensors, with
    `n` = min(size, rows), the count of written rows among them (the
    leading rows are unwritten slots early in a run) and the stride."""
    rows = int(min(rows, buf.capacity))
    rows -= rows % buf.batch_stride
    idx = (buf.ptr - rows + torch.arange(rows, device=buf.reward.device)) % buf.capacity
    snap = {k: getattr(buf, k)[idx].cpu()
            for k in ("obs", "action", "reward", "done", "priority")}
    snap.update(n=min(buf.size, rows), batch_stride=buf.batch_stride)
    return snap


def restore_snapshot(buf: ReplayBuffer, snap) -> ReplayBuffer:
    """Write a `snapshot` into a fresh buffer: its rows land at slots
    [0, rows), the write pointer continues at rows % capacity and the fill
    count is the snapshot's `n`. The last `batch_stride` restored rows are
    marked done, since their ring successors will be frames of unrelated
    episodes: neither TD(0) nor the n-step gather bootstraps across the
    seam."""
    rows = snap["obs"].shape[0]
    if rows > buf.capacity or rows % buf.batch_stride:
        raise ValueError(f"ring snapshot ({rows} rows, stride {int(snap['batch_stride'])}) "
                         f"incompatible with buffer (capacity {buf.capacity}, stride "
                         f"{buf.batch_stride})")
    for k in ("obs", "action", "reward", "done", "priority"):
        col = getattr(buf, k)
        col[:rows] = snap[k].to(device=col.device, dtype=col.dtype)
    buf.done[max(rows - buf.batch_stride, 0):rows] = True
    buf.ptr = rows % buf.capacity
    buf.size = int(snap["n"])
    return buf
