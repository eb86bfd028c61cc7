"""DQN with a target network and importance-weighted Huber loss (port of
deep_rl_grasping_tpu/algos/dqn.py).

Defaults follow stable-baselines as the JAX package does: gamma from
`discount_factor`, the target network copied every
`target_network_update_freq` updates, no double DQN, the dueling
`QNetwork`, epsilon-greedy exploration annealed linearly from 1 to
`exploration_final_eps` over `exploration_fraction * total_timesteps` env
frames (the trainer passes the frame count). One Adam with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8), as algos/sac.py uses. `update`
takes a batch dict from algos/replay.py (its `weight` column holds the
prioritized sampler's importance weights, 1 otherwise) and returns the
metrics and |TD| per row, which the trainer writes back as priorities.

`QLearner` holds what DQN and BDQ (algos/bdq.py) share: the online and
target networks, the optimizer, the epsilon schedule, the update's
bookkeeping and the checkpoint state. Every random draw takes an explicit
`torch.Generator`.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F

from deep_rl_grasping_tpu_torch.algos.sac import load_optimizer
from deep_rl_grasping_tpu_torch.models.networks import QNetwork


class QLearner:
    """Base of DQN and BDQ. Subclasses build the network (`_build`) and say
    how it acts (`_greedy_and_n`), what the target bootstraps from
    (`_next_value`) and which Q values the target is held against
    (`_q_taken`)."""

    NAME = None
    DEFAULTS = {}
    METRIC_KEYS = ("loss", "td_abs")

    def __init__(self, obs_shape, config, device="cpu"):
        c = config.get(self.NAME, {})
        d = self.DEFAULTS
        self.device = torch.device(device)
        self.gamma = float(config.get("discount_factor", 0.99))
        self.lr = float(c.get("learning_rate", d["learning_rate"]))
        self.batch_size = int(c.get("batch_size", d["batch_size"]))
        self.prioritized = bool(c.get("prioritized_replay", d["prioritized_replay"]))
        self.target_update_freq = int(c.get("target_network_update_freq",
                                            d["target_network_update_freq"]))
        self.exploration_fraction = float(c.get("exploration_fraction",
                                                d["exploration_fraction"]))
        self.exploration_final_eps = float(c.get("exploration_final_eps",
                                                 d["exploration_final_eps"]))
        self.total_timesteps = int(c.get("total_timesteps", d["total_timesteps"]))
        self.obs_shape = tuple(obs_shape)
        self.image_obs = len(self.obs_shape) == 3
        self.net = self._build(c).to(self.device)
        self.target_net = copy.deepcopy(self.net).requires_grad_(False)
        self.step = 0
        # data-parallel: maps the gradients to their mean over ranks
        # (dqn.py:96-97, bdq.py:122-123); set by parallel/train_dp.py
        self.grad_mean = None
        self.reset_optimizer()

    def reset_optimizer(self):
        """A fresh Adam: zero moments, zero count (optax's init)."""
        self.opt = torch.optim.Adam(self.net.parameters(), lr=self.lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    def epsilon(self, frames):
        """Exploration rate after `frames` env frames: linear from 1 to the
        final rate over exploration_fraction * total_timesteps frames."""
        frac = min(frames / max(self.exploration_fraction * self.total_timesteps, 1), 1.0)
        return 1.0 + frac * (self.exploration_final_eps - 1.0)

    @torch.no_grad()
    def act(self, obs, gen: torch.Generator = None, epsilon=0.0):
        """Epsilon-greedy actions (per branch for BDQ), int32; greedy when
        epsilon is 0."""
        greedy, n = self._greedy_and_n(self.net(obs))
        if epsilon <= 0.0:
            return greedy.to(torch.int32)
        rand = torch.randint(0, n, greedy.shape, generator=gen, device=greedy.device)
        explore = torch.rand(greedy.shape, generator=gen, device=greedy.device) < epsilon
        return torch.where(explore, rand, greedy).to(torch.int32)

    def update(self, batch, gen=None):
        """One gradient step on a batch dict (obs, action, reward, discount
        or done, next_obs, weight). Returns (metrics of tensors, |TD| per
        row); the target network follows every target_update_freq steps."""
        with torch.no_grad():
            disc = batch.get("discount")
            if disc is None:
                disc = self.gamma * (1.0 - batch["done"].to(torch.float32))
            target = batch["reward"] + disc * self._next_value(self.target_net(batch["next_obs"]))
        params = list(self.net.parameters())
        q_sa, target_b = self._q_taken(self.net(batch["obs"]), batch["action"], target)
        weight = batch["weight"].reshape((-1,) + (1,) * (q_sa.dim() - 1))
        loss = torch.mean(weight * F.huber_loss(q_sa, target_b, reduction="none", delta=1.0))
        grads = torch.autograd.grad(loss, params)
        if self.grad_mean is not None:
            grads = self.grad_mean(grads)
        for p, g in zip(params, grads):
            p.grad = g
        self.opt.step()
        td_abs = (q_sa.detach() - target_b).abs()
        if td_abs.dim() > 1:
            td_abs = td_abs.mean(-1)
        self.step += 1
        if self.step % self.target_update_freq == 0:
            with torch.no_grad():
                for t, p in zip(self.target_net.parameters(), params):
                    t.copy_(p)
        return dict(loss=loss.detach(), td_abs=td_abs.mean()), td_abs

    # ------------------------------------------------------------------ state

    def state_dict(self):
        return dict(net=self.net.state_dict(), target_net=self.target_net.state_dict(),
                    opt=self.opt.state_dict(), step=self.step)

    def load_state_dict(self, sd):
        self.net.load_state_dict(sd["net"])
        self.target_net.load_state_dict(sd["target_net"])
        load_optimizer(self.opt, sd["opt"])
        self.step = int(sd["step"])


class DQN(QLearner):
    NAME = "DQN"
    DEFAULTS = dict(learning_rate=1e-3, batch_size=32, prioritized_replay=True,
                    target_network_update_freq=500, exploration_fraction=0.1,
                    exploration_final_eps=0.02, total_timesteps=1_000_000)

    def __init__(self, obs_shape, num_actions, config, device="cpu"):
        self.num_actions = int(num_actions)
        super().__init__(obs_shape, config, device)

    def _build(self, c):
        self.layers = tuple(c.get("layers", [64, 64]))
        return QNetwork(self.obs_shape, self.num_actions, self.layers, self.image_obs,
                        dueling=True)

    def _greedy_and_n(self, q):
        return torch.argmax(q, -1), self.num_actions

    @staticmethod
    def _next_value(q_next):
        return q_next.amax(-1)

    @staticmethod
    def _q_taken(q, action, target):
        a = action.to(torch.int64).reshape(-1)
        return q.gather(-1, a[:, None])[:, 0], target
