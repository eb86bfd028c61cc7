"""DDPG (port of deep_rl_grasping_tpu/algos/ddpg.py).

`DeterministicActor` (ddpg.py:24-33): the augmented Nature CNN on image
observations, a [layers] MLP and a tanh dense head. `SingleCritic`
(:36-44): its own torso on image observations, the action concatenated
after it, a [layers] MLP and a scalar head. The MLPs compute in bfloat16
with float32 parameters; the heads are float32, as in the other networks.

Exploration adds Gaussian noise of std `noise_sigma` and clips to [-1, 1]
(no Ornstein-Uhlenbeck process). `update` (:111-157) takes a batch from
algos/replay.py: the target bootstraps from the target actor and critic
with the n-step `discount` column when the batch has one, else gamma times
(1 - done); the critic's squared TD error is weighted by `weight`; the
actor's loss is the negated Q of the critic after this update's critic
step; both target networks then move by Polyak averaging (`tau`, default
0.001) toward the updated parameters. Two Adams with optax's defaults. It
returns the metrics and |TD| per row. Every random draw takes an explicit
`torch.Generator`.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from deep_rl_grasping_tpu_torch.algos.sac import load_optimizer
from deep_rl_grasping_tpu_torch.models.networks import MLP, AugmentedNatureCNN


def _torso(obs_shape, image_obs):
    if image_obs:
        torso = AugmentedNatureCNN(tuple(obs_shape), num_direct_features=1)
        return torso, torso.out_features
    return None, obs_shape[0]


class DeterministicActor(nn.Module):
    def __init__(self, obs_shape, action_dim, layers=(64, 64), image_obs=False):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        self.torso, n_in = _torso(self.obs_shape, image_obs)
        self.mlp = MLP(n_in, layers)
        self.head = nn.Linear(layers[-1], action_dim)

    def forward(self, obs):
        h = obs if self.torso is None else self.torso(obs)
        return torch.tanh(self.head(self.mlp(h)))


class SingleCritic(nn.Module):
    def __init__(self, obs_shape, action_dim, layers=(64, 64), image_obs=False):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        self.torso, n_in = _torso(self.obs_shape, image_obs)
        self.mlp = MLP(n_in + action_dim, layers)
        self.head = nn.Linear(layers[-1], 1)

    def forward(self, obs, action):
        h = obs if self.torso is None else self.torso(obs)
        x = torch.cat([h.to(torch.float32), action.to(torch.float32)], -1)
        return self.head(self.mlp(x))[..., 0]


class DDPG:
    METRIC_KEYS = ("critic_loss", "actor_loss")

    def __init__(self, obs_shape, action_dim, config, device="cpu"):
        c = config.get("DDPG", {})
        self.device = torch.device(device)
        self.gamma = float(config.get("discount_factor", 0.99))
        self.actor_lr = float(c.get("actor_lr", 1e-4))
        self.critic_lr = float(c.get("critic_lr", 1e-3))
        self.tau = float(c.get("tau", 0.001))
        self.noise_sigma = float(c.get("noise_sigma", 0.1))
        self.layers = tuple(c.get("layers", (64, 64)))
        self.action_dim = int(action_dim)
        self.obs_shape = tuple(obs_shape)
        image_obs = len(self.obs_shape) == 3
        self.actor = DeterministicActor(self.obs_shape, self.action_dim, self.layers,
                                        image_obs).to(self.device)
        self.critic = SingleCritic(self.obs_shape, self.action_dim, self.layers,
                                   image_obs).to(self.device)
        self.target_actor = copy.deepcopy(self.actor).requires_grad_(False)
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(False)
        self.step = 0
        self.reset_optimizers()

    def reset_optimizers(self):
        """Fresh Adams: zero moments, zero count (optax's init)."""
        adam = lambda params, lr: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        self.actor_opt = adam(self.actor.parameters(), self.actor_lr)
        self.critic_opt = adam(self.critic.parameters(), self.critic_lr)

    @torch.no_grad()
    def act(self, obs, gen: torch.Generator = None, deterministic=False, noise=None):
        """The actor's action, or with `noise_sigma` Gaussian noise (standard
        normal `noise` when given) added and clipped to [-1, 1]."""
        a = self.actor(obs)
        if deterministic:
            return a
        if noise is None:
            noise = torch.randn(a.shape, generator=gen, device=a.device)
        return torch.clamp(a + noise * self.noise_sigma, -1.0, 1.0)

    @staticmethod
    def _step(opt, params, loss):
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step()

    def update(self, batch, gen=None):
        """One critic and one actor step on a batch dict (obs, action,
        reward, discount or done, next_obs, weight). Returns (metrics of
        tensors, |TD| per row)."""
        obs = batch["obs"]
        with torch.no_grad():
            q_next = self.target_critic(batch["next_obs"], self.target_actor(batch["next_obs"]))
            disc = batch.get("discount")
            if disc is None:
                disc = self.gamma * (1.0 - batch["done"].to(torch.float32))
            target = batch["reward"] + disc * q_next
        critic_params = list(self.critic.parameters())
        td = self.critic(obs, batch["action"]) - target
        critic_loss = torch.mean(batch["weight"] * td ** 2)
        self._step(self.critic_opt, critic_params, critic_loss)

        actor_params = list(self.actor.parameters())
        actor_loss = -self.critic(obs, self.actor(obs)).mean()
        self._step(self.actor_opt, actor_params, actor_loss)

        with torch.no_grad():
            for target_net, params in ((self.target_actor, actor_params),
                                       (self.target_critic, critic_params)):
                tp = list(target_net.parameters())
                torch._foreach_mul_(tp, 1.0 - self.tau)
                torch._foreach_add_(tp, [p.detach() for p in params], alpha=self.tau)
        self.step += 1
        return dict(critic_loss=critic_loss.detach(), actor_loss=actor_loss.detach()), \
            td.detach().abs()

    # ------------------------------------------------------------------ state

    def state_dict(self):
        return dict(actor=self.actor.state_dict(), critic=self.critic.state_dict(),
                    target_actor=self.target_actor.state_dict(),
                    target_critic=self.target_critic.state_dict(),
                    actor_opt=self.actor_opt.state_dict(),
                    critic_opt=self.critic_opt.state_dict(), step=self.step)

    def load_state_dict(self, sd):
        for name in ("actor", "critic", "target_actor", "target_critic"):
            getattr(self, name).load_state_dict(sd[name])
        load_optimizer(self.actor_opt, sd["actor_opt"])
        load_optimizer(self.critic_opt, sd["critic_opt"])
        self.step = int(sd["step"])
