"""Soft Actor-Critic (port of deep_rl_grasping_tpu/algos/sac.py).

Twin-Q critic with a Polyak-averaged target (tau 0.005), a squashed-Gaussian
actor, and the entropy coefficient tuned towards a (possibly annealed)
target entropy; three Adams with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8) on the same optional linear learning-rate decay (sac.py:95-117).
The update (sac.py:170) clips the n-step Bellman target to `q_clip` and,
on the demonstration tail of a mixed batch, adds the Q-filtered
behaviour-cloning term `bc_weight * E[1{Q(s, a_demo) > Q(s, a_pi)} *
||tanh(mu) - a_demo||^2]`. Gradients come from autograd over the
`nn.Module`s; the JAX package has no backward kernel either.

Every random draw takes an explicit `torch.Generator`. Only tests pass the
update's noise in as tensors, to reproduce the JAX package's draws.
"""

from __future__ import annotations

import copy
import math

import torch

from deep_rl_grasping_tpu_torch.models.networks import SACActor, SACCritic


@torch.no_grad()
def act(actor: SACActor, obs, generator: torch.Generator = None, deterministic=False):
    """tanh(mean) when deterministic, else a squashed-Gaussian sample drawn
    with `generator`."""
    mean, log_std = actor(obs)
    if deterministic:
        return torch.tanh(mean)
    eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return torch.tanh(mean + torch.exp(log_std) * eps)


def sample_action(actor: SACActor, obs, eps):
    """Squashed-Gaussian sample for standard normal noise `eps` and its log
    probability (sac.py:143)."""
    mean, log_std = actor(obs)
    action = torch.tanh(mean + torch.exp(log_std) * eps)
    log_prob = (-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
    log_prob = log_prob - torch.log(1 - action ** 2 + 1e-6).sum(-1)
    return action, log_prob


def linear_schedule(init_value, end_value, transition_steps, transition_begin=0):
    """optax.linear_schedule as a function of the update count."""
    def schedule(count):
        c = min(max(count - transition_begin, 0), transition_steps)
        return (init_value - end_value) * (1.0 - c / transition_steps) + end_value
    return schedule


class SAC:
    def __init__(self, obs_shape, action_dim, config, device="cpu"):
        c = config.get("SAC", {})
        self.device = torch.device(device)
        self.gamma = float(config.get("discount_factor", 0.99))
        self.tau = 0.005
        self.lr = float(c.get("step_size", 3e-4))
        self.batch_size = int(c.get("batch_size", 256))
        self.layers = tuple(c.get("layers", [64, 64]))
        self.action_dim = int(action_dim)
        self.target_entropy = float(c.get("target_entropy", -float(action_dim)))
        self.target_entropy_final = c.get("target_entropy_final")
        self.target_entropy_anneal = float(c.get("target_entropy_anneal", 0) or 0)
        q_clip = c.get("q_clip")
        self.q_clip = None if q_clip is None else (float(q_clip[0]), float(q_clip[1]))
        self.bc_weight = float(c.get("bc_weight", 0) or 0)
        # demo rows are the static tail of the trainer's mixed batches
        demo_frac = float(config.get("tpu", {}).get("demo_fraction", 0) or 0)
        self.bc_tail = int(round(self.batch_size * demo_frac))
        self.obs_shape = tuple(obs_shape)
        self.image_obs = len(self.obs_shape) == 3

        self.actor = SACActor(self.obs_shape, self.action_dim, self.layers,
                              self.image_obs).to(self.device)
        self.critic = SACCritic(self.obs_shape, self.action_dim, self.layers,
                                self.image_obs).to(self.device)
        self.target_critic = copy.deepcopy(self.critic).requires_grad_(False)
        self.log_alpha = torch.zeros((), device=self.device, requires_grad=True)
        self.step = 0
        decay_steps = int(c.get("lr_decay_steps", 0) or 0)
        if decay_steps > 0:
            self.lr_at = linear_schedule(self.lr, self.lr * float(c.get("lr_final_scale", 0.1)),
                                         decay_steps, int(c.get("lr_decay_begin", 0) or 0))
        else:
            self.lr_at = lambda count: self.lr
        self.reset_optimizers()

    def reset_optimizers(self):
        """Fresh Adams: zero moments, zero count (optax's init)."""
        adam = lambda params: torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        self.actor_opt = adam(self.actor.parameters())
        self.critic_opt = adam(self.critic.parameters())
        self.alpha_opt = adam([self.log_alpha])

    # ------------------------------------------------------------------ update

    def _apply(self, opt, params, grads, lr):
        for p, g in zip(params, grads):
            p.grad = g
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()

    def update(self, batch, gen=None, target_entropy=None, noise=None):
        """One SAC gradient step on a batch dict (obs, action, reward,
        discount or done, next_obs, weight, optional is_demo). Returns
        (metrics of tensors, per-row |TD|). `noise` = (eps_next, eps_pi)
        replaces the two standard-normal draws."""
        if target_entropy is None:
            target_entropy = self.target_entropy
        obs, next_obs, action = batch["obs"], batch["next_obs"], batch["action"]
        n, dev = obs.shape[0], obs.device
        if noise is None:
            shape = (n, self.action_dim)
            noise = (torch.randn(shape, generator=gen, device=dev),
                     torch.randn(shape, generator=gen, device=dev))
        eps_next, eps_pi = noise
        lr = self.lr_at(self.step)
        alpha = torch.exp(self.log_alpha.detach())

        with torch.no_grad():
            next_action, next_logp = sample_action(self.actor, next_obs, eps_next)
            q_next = self.target_critic(next_obs, next_action).amin(-1)
            disc = batch.get("discount")
            if disc is None:
                disc = self.gamma * (1.0 - batch["done"].to(torch.float32))
            target = batch["reward"] + disc * (q_next - alpha * next_logp)
            if self.q_clip is not None:
                target = torch.clamp(target, self.q_clip[0], self.q_clip[1])

        critic_params = list(self.critic.parameters())
        td = self.critic(obs, action) - target[:, None]
        critic_loss = torch.mean(batch["weight"][:, None] * td ** 2)
        self._apply(self.critic_opt, critic_params,
                    torch.autograd.grad(critic_loss, critic_params), lr)
        td_abs = td.detach().abs().mean(-1)

        actor_params = list(self.actor.parameters())
        a, logp = sample_action(self.actor, obs, eps_pi)
        q = self.critic(obs, a).amin(-1)
        actor_loss = torch.mean(alpha * logp - q)
        zero = torch.zeros((), device=dev)
        bc_loss, bc_gate = zero, zero
        if self.bc_weight > 0 and "is_demo" in batch:
            t = self.bc_tail if 0 < self.bc_tail < n and n == self.batch_size else n
            obs_t, act_t = obs[-t:], action[-t:]
            mean_t, _ = self.actor(obs_t)
            with torch.no_grad():
                q_demo = self.critic(obs_t, act_t).amin(-1)
                is_demo = batch["is_demo"][-t:]
                mask = (is_demo & (q_demo > q[-t:])).to(torch.float32) * batch["weight"][-t:]
                bc_gate = (mask > 0).to(torch.float32).sum() / torch.clamp(
                    is_demo.to(torch.float32).sum(), min=1.0)
            se = ((torch.tanh(mean_t) - act_t) ** 2).sum(-1)
            bc_loss = (mask * se).sum() / torch.clamp(mask.sum(), min=1.0)
            actor_loss = actor_loss + self.bc_weight * bc_loss
        self._apply(self.actor_opt, actor_params,
                    torch.autograd.grad(actor_loss, actor_params), lr)

        logp = logp.detach()
        alpha_loss = -torch.mean(self.log_alpha * (logp + target_entropy))
        self._apply(self.alpha_opt, [self.log_alpha],
                    torch.autograd.grad(alpha_loss, [self.log_alpha]), lr)

        with torch.no_grad():
            tp = list(self.target_critic.parameters())
            torch._foreach_mul_(tp, 1.0 - self.tau)
            torch._foreach_add_(tp, [p.detach() for p in critic_params], alpha=self.tau)
        self.step += 1
        metrics = dict(
            critic_loss=critic_loss.detach(), actor_loss=actor_loss.detach(),
            bc_loss=bc_loss.detach(), bc_gate=bc_gate, alpha_loss=alpha_loss.detach(),
            alpha=alpha, entropy=-logp.mean(), td_abs=td_abs.mean(),
            q_target_mean=target.mean(), reward_mean=batch["reward"].mean(),
            reward_max=batch["reward"].max(),
            done_frac=batch["done"].to(torch.float32).mean(),
        )
        return metrics, td_abs

    # ------------------------------------------------------------------ state

    def state_dict(self):
        return dict(actor=self.actor.state_dict(), critic=self.critic.state_dict(),
                    target_critic=self.target_critic.state_dict(),
                    log_alpha=self.log_alpha.detach().clone(),
                    actor_opt=self.actor_opt.state_dict(),
                    critic_opt=self.critic_opt.state_dict(),
                    alpha_opt=self.alpha_opt.state_dict(), step=self.step)

    def load_state_dict(self, sd):
        self.actor.load_state_dict(sd["actor"])
        self.critic.load_state_dict(sd["critic"])
        self.target_critic.load_state_dict(sd["target_critic"])
        with torch.no_grad():
            self.log_alpha.copy_(sd["log_alpha"])
        self.actor_opt.load_state_dict(sd["actor_opt"])
        self.critic_opt.load_state_dict(sd["critic_opt"])
        self.alpha_opt.load_state_dict(sd["alpha_opt"])
        self.step = int(sd["step"])
