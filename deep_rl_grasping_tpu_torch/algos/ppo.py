"""PPO with the clipped surrogate (port of deep_rl_grasping_tpu/algos/ppo.py).

`ActorCritic` (ppo.py:23-44) has an optional augmented Nature CNN torso
(image observations), then two [layers] MLP towers with no shared weights:
the policy tower ends in a dense head of logits (discrete) or Gaussian
means (continuous, with a free state-independent `log_std`, zeros at
init), the value tower in a dense scalar. The towers compute in bfloat16
with float32 parameters; the heads are float32 layers fed the towers'
bfloat16 outputs, as the Flax `Dense` heads with no `dtype` are.

`ActorCriticLearner` holds what PPO and TRPO (algos/trpo.py) share: the
network, the log-probability and entropy of given actions (ppo.py:90-104),
`act` (:106-119; the continuous action is clipped to [-1, 1] and its
log-probability is that of the clipped action), `value` and `gae`
(:126-143, a reverse scan over (T, B)).

`PPO.update` (:145-176) takes one minibatch: advantages standardised with
the population std (ddof 0, as `jnp.std`), the clipped ratio objective,
the value loss clipped by `clip_range` around the rollout's values, the
entropy bonus; then the global-norm clip at 0.5 and Adam with optax's
defaults (b1 0.9, b2 0.999, eps 1e-8). The clip is optax's rule
(`clip_by_global_norm`: scale by max_norm / norm once norm reaches
max_norm, no epsilon), not `torch.nn.utils.clip_grad_norm_`, which adds
1e-6 to the norm. Every random draw takes an explicit `torch.Generator`;
tests hand `act` the JAX package's noise instead.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from deep_rl_grasping_tpu_torch.algos.sac import load_optimizer
from deep_rl_grasping_tpu_torch.models.networks import MLP, AugmentedNatureCNN

LOG_2PI = math.log(2.0 * math.pi)
GRAD_CLIP = 0.5


class ActorCritic(nn.Module):
    """Returns (logits or mean (B, A), log_std (A,) or None, value (B,))."""

    def __init__(self, obs_shape, action_dim, discrete=False, layers=(64, 64), image_obs=False):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        self.discrete = bool(discrete)
        self.image_obs = bool(image_obs)
        if image_obs:
            self.torso = AugmentedNatureCNN(self.obs_shape, num_direct_features=1)
            n_in = self.torso.out_features
        else:
            self.torso = None
            n_in = self.obs_shape[0]
        self.pi = MLP(n_in, layers)
        self.vf = MLP(n_in, layers)
        self.head = nn.Linear(layers[-1], action_dim)
        self.value_head = nn.Linear(layers[-1], 1)
        self.log_std = None if discrete else nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs):
        h = obs if self.torso is None else self.torso(obs)
        out = self.head(self.pi(h))
        value = self.value_head(self.vf(h))[..., 0]
        return out, self.log_std, value


def global_norm_clip_(grads, max_norm):
    """optax.clip_by_global_norm on a list of gradients, in place, with no
    host sync: unchanged below `max_norm`, else scaled to norm `max_norm`."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


def standardize(adv):
    """(adv - mean) / (population std + 1e-8), as ppo.py:149 and trpo.py:122."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


class ActorCriticLearner:
    """Base of PPO and TRPO; subclasses read their config block (NAME) in
    `_configure` and define `update`."""

    NAME = None
    METRIC_KEYS = ()

    def __init__(self, obs_shape, action_dim, config, discrete=False, device="cpu"):
        c = config.get(self.NAME, {})
        self.device = torch.device(device)
        self.gamma = float(config.get("discount_factor", 0.99))
        self.n_steps = int(c.get("n_steps", 128))
        self.layers = tuple(c.get("layers", [64, 64]))
        self.discrete = bool(discrete)
        self.action_dim = int(action_dim)
        self.obs_shape = tuple(obs_shape)
        self.image_obs = len(self.obs_shape) == 3
        self._configure(c)
        self.net = ActorCritic(self.obs_shape, self.action_dim, self.discrete, self.layers,
                               self.image_obs).to(self.device)
        self.step = 0
        self.reset_optimizer()

    def reset_optimizer(self):
        """A fresh Adam over every parameter: zero moments, zero count."""
        self.opt = torch.optim.Adam(self.net.parameters(), lr=self.lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    # ------------------------------------------------------------------ policy

    def logp_entropy(self, out, log_std, action):
        """Log-probability of `action` and the entropy, per row."""
        if self.discrete:
            logp_all = F.log_softmax(out, -1)
            logp = logp_all.gather(-1, action.to(torch.int64)[..., None])[..., 0]
            return logp, -(logp_all.exp() * logp_all).sum(-1)
        std = torch.exp(log_std)
        logp = (-0.5 * (((action - out) / std) ** 2 + 2 * log_std + LOG_2PI)).sum(-1)
        ent = (log_std + 0.5 * (LOG_2PI + 1.0)).sum(-1)
        return logp, ent.expand(logp.shape)

    @torch.no_grad()
    def act(self, obs, gen: torch.Generator = None, deterministic=False, noise=None):
        """(action, its log-probability, value). Discrete: the argmax, or a
        draw as `jax.random.categorical` makes it (argmax of logits plus
        Gumbel noise); continuous: the mean plus std-scaled standard normal
        noise, clipped to [-1, 1]. `noise` replaces the draw."""
        out, log_std, value = self.net(obs)
        if not deterministic and noise is None:
            if self.discrete:
                u = torch.rand(out.shape, generator=gen, device=out.device)
                noise = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
            else:
                noise = torch.randn(out.shape, generator=gen, device=out.device)
        if self.discrete:
            action = torch.argmax(out if deterministic else out + noise, -1).to(torch.int32)
        else:
            action = out if deterministic else out + noise * torch.exp(log_std)
            action = torch.clamp(action, -1.0, 1.0)
        logp, _ = self.logp_entropy(out, log_std, action)
        return action, logp, value

    @torch.no_grad()
    def value(self, obs):
        return self.net(obs)[2]

    def gae(self, rewards, values, dones, last_value):
        """Generalised advantage estimates and returns of a (T, B) rollout."""
        adv = torch.zeros_like(values)
        adv_next, v_next = torch.zeros_like(last_value), last_value
        for t in range(rewards.shape[0] - 1, -1, -1):
            nonterm = 1.0 - dones[t].to(torch.float32)
            delta = rewards[t] + self.gamma * v_next * nonterm - values[t]
            adv_next = delta + self.gamma * self.gae_lambda * nonterm * adv_next
            adv[t] = adv_next
            v_next = values[t]
        return adv, adv + values

    # ------------------------------------------------------------------ state

    def state_dict(self):
        return dict(net=self.net.state_dict(), opt=self.opt.state_dict(), step=self.step)

    def load_state_dict(self, sd):
        self.net.load_state_dict(sd["net"])
        load_optimizer(self.opt, sd["opt"])
        self.step = int(sd["step"])


class PPO(ActorCriticLearner):
    NAME = "PPO"
    METRIC_KEYS = ("loss", "pg_loss", "vf_loss", "entropy", "grad_norm")

    def _configure(self, c):
        self.lr = float(c.get("learning_rate", 3e-4))
        self.n_epochs = int(c.get("n_epochs", 4))
        self.n_minibatches = int(c.get("n_minibatches", 4))
        self.clip = float(c.get("clip_range", 0.2))
        self.gae_lambda = float(c.get("lam", 0.95))
        self.vf_coef = float(c.get("vf_coef", 0.5))
        self.ent_coef = float(c.get("ent_coef", 0.01))

    def update(self, batch):
        """One gradient step on a minibatch dict (obs, action, logp,
        advantage, return, value). Returns the metrics as tensors, with
        the gradient's global norm before the clip."""
        adv = standardize(batch["advantage"])
        params = list(self.net.parameters())
        out, log_std, value = self.net(batch["obs"])
        logp, ent = self.logp_entropy(out, log_std, batch["action"])
        ratio = torch.exp(logp - batch["logp"])
        pg_loss = -torch.minimum(ratio * adv,
                                 torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv).mean()
        v_old, ret = batch["value"], batch["return"]
        v_clip = v_old + torch.clamp(value - v_old, -self.clip, self.clip)
        vf_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clip - ret) ** 2).mean()
        loss = pg_loss + self.vf_coef * vf_loss - self.ent_coef * ent.mean()
        grads = list(torch.autograd.grad(loss, params))
        grad_norm = global_norm_clip_(grads, GRAD_CLIP)
        for p, g in zip(params, grads):
            p.grad = g
        self.opt.step()
        self.step += 1
        return dict(loss=loss.detach(), pg_loss=pg_loss.detach(), vf_loss=vf_loss.detach(),
                    entropy=ent.detach().mean(), grad_norm=grad_norm)
