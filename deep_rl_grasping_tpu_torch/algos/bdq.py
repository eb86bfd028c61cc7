"""Branch Dueling Q-Network learner, the thesis's algorithm (port of
deep_rl_grasping_tpu/algos/bdq.py; Tavakoli et al. 2018, "Action Branching
Architectures for Deep Reinforcement Learning").

One branch per action dimension with `num_actions_pad` bins each (3 on the
simplified task: dx, dy, dyaw); the env applies every branch's bin at once
(`GraspEnv.branched_actions`). Per-branch epsilon-greedy; the TD target is
the mean over branches of the target network's per-branch max, shared by
every branch's Huber loss; |TD| per row is the mean over branches. The
rest (target network, Adam, epsilon schedule, checkpoint state) is
algos/dqn.py's `QLearner`.
"""

from __future__ import annotations

import torch

from deep_rl_grasping_tpu_torch.algos.dqn import QLearner
from deep_rl_grasping_tpu_torch.models.networks import BDQNetwork


class BDQ(QLearner):
    NAME = "BDQ"
    DEFAULTS = dict(learning_rate=1e-4, batch_size=64, prioritized_replay=False,
                    target_network_update_freq=1000, exploration_fraction=0.3,
                    exploration_final_eps=0.1, total_timesteps=4_000_000)

    def __init__(self, obs_shape, num_branches, config, device="cpu"):
        self.num_branches = int(num_branches)
        self.num_actions_pad = int(config.get(self.NAME, {}).get("num_actions_pad", 33))
        super().__init__(obs_shape, config, device)

    def _build(self, c):
        trunk, branch, value = c.get("layers", [[64, 64], [32], [32]])
        self.layers = (tuple(trunk), tuple(branch), tuple(value))
        return BDQNetwork(self.obs_shape, self.num_branches, self.num_actions_pad,
                          *self.layers, image_obs=self.image_obs)

    def _greedy_and_n(self, q):
        return torch.argmax(q, -1), self.num_actions_pad

    @staticmethod
    def _next_value(q_next):
        return q_next.amax(-1).mean(-1)

    @staticmethod
    def _q_taken(q, action, target):
        a = action.to(torch.int64)
        return q.gather(-1, a[..., None])[..., 0], target[:, None].expand(-1, a.shape[-1])
