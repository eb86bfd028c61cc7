"""TRPO (port of deep_rl_grasping_tpu/algos/trpo.py).

One natural-gradient step per rollout, on PPO's `ActorCritic` and GAE
(algos/ppo.py): the surrogate's gradient g, then `cg_iters` rounds of
conjugate gradient on F x = g, where F v is the Fisher-vector product (the
gradient of the mean KL's gradient dotted with v, a double backward, plus
`cg_damping` v; trpo.py:144-171, with its 1e-12 guards); the step
sqrt(max_kl / (x'Fx / 2)) x; a backtracking line search that takes the
first fraction 0.5**k, k = 0..9, whose surrogate gain exceeds a tenth of
the expected one and whose mean KL stays within 1.5 max_kl, and otherwise
keeps the old parameters (:179-200); then `vf_iters` Adam steps on the
value loss (:202-217).

Parameters are flattened with `parameters_to_vector` in the module's
fixed order, where the JAX package ravels its param tree. That Adam runs
over every parameter, as `vf_opt = adam.init(params)` does: the policy's
parameters get zero gradients, so their moments stay zero and their step
is exactly zero; an image torso moves in both phases. The KL's first
gradient is built once per update with `create_graph` and reused by every
Fisher-vector product, where the JAX package recomputes it; the products
are the same. `entcoeff` is read and, as in the JAX package, never used.
"""

from __future__ import annotations

import torch
from torch.nn.utils import parameters_to_vector, vector_to_parameters

from deep_rl_grasping_tpu_torch.algos.ppo import ActorCriticLearner, standardize

LINE_SEARCH_STEPS = 10


def _flat_grad(out, params, **kw):
    grads = torch.autograd.grad(out, params, allow_unused=True, **kw)
    return torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for p, g in zip(params, grads)])


class TRPO(ActorCriticLearner):
    NAME = "TRPO"
    METRIC_KEYS = ("surrogate", "kl", "vf_loss", "line_search_ok")

    def _configure(self, c):
        self.max_kl = float(c.get("max_kl", 0.01))
        self.cg_iters = int(c.get("cg_iters", 10))
        self.cg_damping = float(c.get("cg_damping", 0.1))
        self.lr = float(c.get("step_size", 3e-4))  # the value function's Adam
        self.vf_iters = int(c.get("vf_iters", 3))
        self.gae_lambda = float(c.get("lam", 0.98))
        self.entcoeff = float(c.get("entcoeff", 0.0))

    def _kl(self, old, out, log_std):
        """Mean KL(old || new) from the old (logits or mean, log_std) pair."""
        if self.discrete:
            lo, ln = torch.log_softmax(old[0], -1), torch.log_softmax(out, -1)
            return (lo.exp() * (lo - ln)).sum(-1).mean()
        mo, so = old
        kl = (log_std - so + (torch.exp(2 * so) + (mo - out) ** 2) / (2 * torch.exp(2 * log_std))
              - 0.5).sum(-1)
        return kl.mean()

    def update(self, batch):
        """One TRPO update on the whole rollout (obs, action, advantage,
        return). Returns the metrics as tensors."""
        net, obs, action = self.net, batch["obs"], batch["action"]
        adv = standardize(batch["advantage"])
        params = list(net.parameters())
        with torch.no_grad():
            old_out, old_log_std, _ = net(obs)
            old_logp = self.logp_entropy(old_out, old_log_std, action)[0]
        # a copy: the continuous log_std is the parameter itself
        old = (old_out, None if old_log_std is None else old_log_std.detach().clone())

        def surrogate():
            out, log_std, _ = net(obs)
            logp = self.logp_entropy(out, log_std, action)[0]
            return torch.mean(torch.exp(logp - old_logp) * adv)

        def mean_kl():
            out, log_std, _ = net(obs)
            return self._kl(old, out, log_std)

        flat = parameters_to_vector(params).detach()
        surr_before = surrogate()
        g = _flat_grad(surr_before, params)
        kl_grad = _flat_grad(mean_kl(), params, create_graph=True)

        def fvp(v):
            return _flat_grad(kl_grad @ v, params, retain_graph=True) + self.cg_damping * v

        # conjugate gradient on F x = g
        x, r, p = torch.zeros_like(g), g.clone(), g.clone()
        rr = r @ r
        for _ in range(self.cg_iters):
            Ap = fvp(p)
            alpha = rr / torch.clamp(p @ Ap, min=1e-12)
            x = x + alpha * p
            r = r - alpha * Ap
            rr_new = r @ r
            p = r + (rr_new / torch.clamp(rr, min=1e-12)) * p
            rr = rr_new
        shs = 0.5 * (x @ fvp(x))
        del kl_grad
        full_step = torch.sqrt(self.max_kl / torch.clamp(shs, min=1e-12)) * x
        expected_improve = g @ full_step
        surr_before = surr_before.detach()

        # backtracking line search: the first fraction that passes both tests
        found = False
        with torch.no_grad():
            for k in range(LINE_SEARCH_STEPS):
                frac = 0.5 ** k
                vector_to_parameters(flat + frac * full_step, params)
                ok = ((surrogate() - surr_before > 0.1 * frac * expected_improve)
                      & (mean_kl() <= self.max_kl * 1.5))
                if bool(ok):
                    found = True
                    break
            if not found:
                vector_to_parameters(flat, params)

        # value-function fit: Adam over every parameter
        ret = batch["return"]
        for _ in range(self.vf_iters):
            vf_loss = torch.mean((net(obs)[2] - ret) ** 2)
            for p_, g_ in zip(params, torch.autograd.grad(vf_loss, params, allow_unused=True)):
                p_.grad = torch.zeros_like(p_) if g_ is None else g_
            self.opt.step()
        self.step += 1
        with torch.no_grad():
            out, log_std, value = net(obs)
            metrics = dict(surrogate=surr_before, kl=self._kl(old, out, log_std),
                           vf_loss=torch.mean((value - ret) ** 2),
                           line_search_ok=torch.tensor(float(found), device=obs.device))
        return metrics
