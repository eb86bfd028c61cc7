"""The encoder half of the depth-image autoencoder (port of
deep_rl_grasping_tpu/models/autoencoder.py `ConvEncoder` :22-39).

3 x [Conv(32, k 7/5/3, stride 2) + LeakyReLU] -> NHWC flatten ->
Dense(encoding_dim) -> LeakyReLU, computed in bfloat16 with float32
parameters as Flax's `dtype=CDTYPE` does; the last activation in float32.
Layout differences from Flax:

* Flax's `padding="SAME"` with stride 2 pads unevenly: (k - 1 - r) split
  with the smaller half first, e.g. (2, 3) for the 7x7 conv on 64 pixels.
  torch's `padding="same"` refuses strides > 1 and `padding=k // 2` pads
  evenly, so each conv runs unpadded after an explicit `F.pad(lo, hi)`.
* The convolutions run NCHW, but the flatten before the dense layer is in
  NHWC order, so a Flax dense kernel loads with its rows as they are
  (training/train_encoder.py `encoder_state_dict`).

The decoder and the training step are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

CDTYPE = torch.bfloat16


def same_pads(n, k, s):
    """(lo, hi) padding of one spatial axis of length n under XLA's SAME
    rule: output ceil(n / s), the total padding split with the smaller half
    first."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ConvEncoder(nn.Module):
    """(B, H, W, 1) depth images -> (B, encoding_dim) float32 latents;
    `in_hw` (H, W) sizes the dense layer."""

    def __init__(self, filters: Sequence[int] = (32, 32, 32), kernels: Sequence[int] = (7, 5, 3),
                 strides: Sequence[int] = (2, 2, 2), encoding_dim: int = 100, alpha: float = 0.1,
                 in_hw=(64, 64)):
        super().__init__()
        self.kernels, self.strides = tuple(kernels), tuple(strides)
        self.encoding_dim, self.alpha = int(encoding_dim), float(alpha)
        convs, c = [], 1
        h, w = in_hw
        for f, k, s in zip(filters, kernels, strides):
            convs.append(nn.Conv2d(c, f, k, stride=s))
            h, w, c = -(-h // s), -(-w // s), f
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(h * w * c, self.encoding_dim)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(CDTYPE)
        for conv, k, s in zip(self.convs, self.kernels, self.strides):
            (hlo, hhi), (wlo, whi) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
            x = F.conv2d(F.pad(x, (wlo, whi, hlo, hhi)), conv.weight.to(CDTYPE),
                         conv.bias.to(CDTYPE), stride=s)
            x = F.leaky_relu(x, self.alpha)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.linear(x, self.dense.weight.to(CDTYPE), self.dense.bias.to(CDTYPE))
        return F.leaky_relu(x.to(torch.float32), self.alpha)
