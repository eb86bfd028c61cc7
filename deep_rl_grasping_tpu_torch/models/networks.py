"""Policy and value networks as torch `nn.Module`s (port of the SAC parts
of deep_rl_grasping_tpu/models/networks.py: `SACActor`, the twin-Q
`SACCritic` :112-126 and `make_torso` :81).

Convolutions and the trunk's dense layers compute in bfloat16 with float32
parameters, as the JAX package does (networks.py:30-31); the heads stay
float32. The public boundary keeps the JAX layout: observations are
NHWC, (B, H, W, C). Internally the convolutions run NCHW and the flatten
before the 512-wide dense layer is in NCHW order; utils/policy_io.py
permutes that layer's rows when it loads Flax (NHWC-flatten) weights.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

CDTYPE = torch.bfloat16
LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0


def _linear(layer: nn.Linear, x, dtype):
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class NatureCNN(nn.Module):
    """DQN-Nature feature extractor (conv 32x8s4, 64x4s2, 64x3s1 -> FC 512)."""

    SPECS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

    def __init__(self, in_channels, in_hw=(64, 64), features=512):
        super().__init__()
        convs = []
        h, w = in_hw
        c = in_channels
        for out, k, s in self.SPECS:
            convs.append(nn.Conv2d(c, out, k, stride=s))
            h, w, c = (h - k) // s + 1, (w - k) // s + 1, out
        self.convs = nn.ModuleList(convs)
        self.out_chw = (c, h, w)
        self.dense = nn.Linear(c * h * w, features)

    def forward(self, x):  # x: (B, H, W, C)
        x = x.permute(0, 3, 1, 2).to(CDTYPE)
        for conv, (_, _, s) in zip(self.convs, self.SPECS):
            x = F.relu(F.conv2d(x, conv.weight.to(CDTYPE), conv.bias.to(CDTYPE), stride=s))
        x = x.reshape(x.shape[0], -1)
        return F.relu(_linear(self.dense, x, CDTYPE)).to(torch.float32)


class AugmentedNatureCNN(nn.Module):
    """Nature CNN over channels [:-1] plus the direct features stored in the
    last channel (custom_obs_policy.py:15-43)."""

    def __init__(self, obs_shape, num_direct_features=1, features=512):
        super().__init__()
        h, w, c = obs_shape
        self.num_direct_features = num_direct_features
        self.cnn = NatureCNN(c - 1, (h, w), features)
        self.out_features = features + num_direct_features

    def forward(self, x):
        direct = x[..., -1].reshape(x.shape[0], -1)[:, : self.num_direct_features]
        return torch.cat([self.cnn(x[..., :-1]), direct.to(torch.float32)], -1)


class MLP(nn.Module):
    def __init__(self, in_features, layers: Sequence[int], activate_final=True):
        super().__init__()
        dims = [in_features, *layers]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.activate_final = activate_final

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = _linear(layer, x, CDTYPE)
            if i < len(self.layers) - 1 or self.activate_final:
                x = F.relu(x)
        return x.to(torch.float32)


def make_torso(obs_shape, layers, image_obs):
    """Feature extractor as the JAX package selects it (networks.py:81): the
    augmented Nature CNN for image observations, an MLP otherwise.
    Returns (module, number of output features)."""
    if image_obs:
        torso = AugmentedNatureCNN(tuple(obs_shape), num_direct_features=1)
        return torso, torso.out_features
    return MLP(obs_shape[0], layers), layers[-1]


class SACActor(nn.Module):
    """Squashed-Gaussian policy head; returns (mean, log_std) pre-tanh."""

    def __init__(self, obs_shape, action_dim, layers=(64, 64), image_obs=False):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        self.image_obs = image_obs
        self.torso, n_feat = make_torso(self.obs_shape, layers, image_obs)
        self.mlp = MLP(n_feat, layers) if image_obs else None
        self.mean = nn.Linear(layers[-1], action_dim)
        self.log_std = nn.Linear(layers[-1], action_dim)

    def forward(self, obs):
        h = self.torso(obs)
        if self.mlp is not None:
            h = self.mlp(h)
        mean = self.mean(h)
        log_std = torch.clamp(self.log_std(h), LOG_STD_MIN, LOG_STD_MAX)
        return mean, log_std


class SACCritic(nn.Module):
    """Twin Q network: one torso, then two [layers] MLP + scalar heads on
    (features, action). Returns (B, 2)."""

    def __init__(self, obs_shape, action_dim, layers=(64, 64), image_obs=False):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        self.image_obs = image_obs
        self.torso, n_feat = make_torso(self.obs_shape, layers, image_obs)
        self.mlps = nn.ModuleList(MLP(n_feat + action_dim, layers) for _ in range(2))
        self.heads = nn.ModuleList(nn.Linear(layers[-1], 1) for _ in range(2))

    def forward(self, obs, action):
        x = torch.cat([self.torso(obs), action.to(torch.float32)], -1)
        return torch.cat([head(mlp(x)) for mlp, head in zip(self.mlps, self.heads)], -1)
