"""Device-resident uniform replay with n-step returns (port of
deep_rl_grasping_tpu/algos/replay.py: `create` :43, `insert` :68,
`_valid_range` :84, `_nstep_gather` :90, `sample` :109).

Observations are stored once, as flat bfloat16 rows (C, prod(obs_shape)) in
the JAX package's NHWC order; the next observation of frame t is the row one
env batch (`batch_stride`) later. For a terminal frame that row belongs to
the auto-reset episode, and the n-step gather stops at the terminal, so it
is never bootstrapped from. Capacity is rounded down to a multiple of the
insert width. The port writes the ring in place, and keeps the write
pointer and the fill count as Python integers: every insert has the same
width, so both are known without reading the device.

Prioritized replay (replay.py:155-195) and ring snapshots (:197-254) are
not ported yet.
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
        ptr=0, size=0, batch_stride=int(batch_stride), capacity=capacity,
        obs_shape=tuple(obs_shape))


def insert(buf: ReplayBuffer, obs, action, reward, done) -> ReplayBuffer:
    """Write one env batch (batch_stride rows) at the write pointer."""
    B, p = buf.batch_stride, buf.ptr
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
