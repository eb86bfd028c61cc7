"""The depth-image autoencoder (port of
deep_rl_grasping_tpu/models/autoencoder.py: `ConvEncoder` :22-39,
`ConvDecoder` :41-72, `SimpleAutoEncoder` :75-110, `create_ae_train_state`
and `ae_train_step` :113-140).

Encoder: 3 x [Conv(32, k 7/5/3, stride 2) + LeakyReLU] -> NHWC flatten ->
Dense(encoding_dim) -> LeakyReLU. Decoder, mirrored: Dense(8 x 8 x 32) ->
LeakyReLU -> reshape to 8 x 8 x 32, then per upper layer a nearest 2x
upsampling, a stride-1 SAME convolution and a LeakyReLU, and a last
upsampling into a 1-channel convolution. Both compute in bfloat16 with
float32 parameters as Flax's `dtype=CDTYPE` does; the encoder's last
activation and the decoder's output in float32. Layout differences from
Flax:

* Flax's `padding="SAME"` with stride 2 pads unevenly: (k - 1 - r) split
  with the smaller half first, e.g. (2, 3) for the 7x7 conv on 64 pixels.
  torch's `padding="same"` refuses strides > 1 and `padding=k // 2` pads
  evenly, so each conv runs unpadded after an explicit `F.pad(lo, hi)`.
* The convolutions run NCHW, but the flatten before the encoder's dense
  layer and the reshape after the decoder's are in NHWC order, so Flax
  dense kernels load with their rows (columns) as they are
  (training/train_encoder.py `ae_state_dict`).
* Nearest upsampling by an integer factor s takes source pixel i // s in
  both `jax.image.resize(method="nearest")` and
  `F.interpolate(mode="nearest")` (tests/test_torch_autoencoder.py).

Training: MSE between the reconstruction and the input, Adam as
`optax.adam(lr)` (b1 0.9, b2 0.999, eps 1e-8 outside the square root, the
same bias correction). Parameters start as Flax's do (kernels LeCun-normal,
truncated at two standard deviations, biases zero), drawn from an explicit
`torch.Generator`.
"""

from __future__ import annotations

import math
import os
import re
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils

CDTYPE = torch.bfloat16

# the JAX package's DEFAULT_ENCODER_CONFIG (:33), used when a config file
# or an encoder directory's config.yaml is missing
DEFAULT_ENCODER_CONFIG = {
    "network": [
        {"filters": 32, "kernel_size": 7, "strides": 2},
        {"filters": 32, "kernel_size": 5, "strides": 2},
        {"filters": 32, "kernel_size": 3, "strides": 2},
    ],
    "encoding_dim": 100,
    "learning_rate": 0.0002,
    "batch_size": 128,
    "epochs": 120,
}


def same_pads(n, k, s):
    """(lo, hi) padding of one spatial axis of length n under XLA's SAME
    rule: output ceil(n / s), the total padding split with the smaller half
    first."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(x, conv, k, s):
    """`conv` (its parameters cast to bf16) on bf16 NCHW `x` with SAME
    padding at stride s."""
    (hlo, hhi), (wlo, whi) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    return F.conv2d(F.pad(x, (wlo, whi, hlo, hhi)), conv.weight.to(CDTYPE),
                    conv.bias.to(CDTYPE), stride=s)


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
            x = F.leaky_relu(_conv_same(x, conv, k, s), self.alpha)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.linear(x, self.dense.weight.to(CDTYPE), self.dense.bias.to(CDTYPE))
        return F.leaky_relu(x.to(torch.float32), self.alpha)


class ConvDecoder(nn.Module):
    """(B, encoding_dim) latents -> (B, H, W, 1) float32 images, H = W =
    base_hw times the product of the strides."""

    def __init__(self, filters: Sequence[int] = (32, 32, 32), kernels: Sequence[int] = (7, 5, 3),
                 strides: Sequence[int] = (2, 2, 2), encoding_dim: int = 100, alpha: float = 0.1,
                 base_hw: int = 8):
        super().__init__()
        self.filters, self.kernels = tuple(filters), tuple(kernels)
        self.strides, self.alpha, self.base_hw = tuple(strides), float(alpha), int(base_hw)
        n = len(self.filters)
        self.dense = nn.Linear(int(encoding_dim), self.base_hw ** 2 * self.filters[-1])
        # Flax creation order: Conv_0 .. Conv_{n-2} on the upper layers from
        # the top down, then the 1-channel Conv_{n-1}
        convs = [nn.Conv2d(self.filters[i], self.filters[i - 1], self.kernels[i])
                 for i in reversed(range(1, n))]
        convs.append(nn.Conv2d(self.filters[0], 1, self.kernels[0]))
        self.convs = nn.ModuleList(convs)

    def forward(self, z):
        n, hw, c = len(self.filters), self.base_hw, self.filters[-1]
        x = F.linear(z.to(CDTYPE), self.dense.weight.to(CDTYPE), self.dense.bias.to(CDTYPE))
        x = F.leaky_relu(x, self.alpha)
        x = x.reshape(x.shape[0], hw, hw, c).permute(0, 3, 1, 2)
        layers = list(reversed(range(n)))  # the stride and kernel of each conv
        for j, (conv, i) in enumerate(zip(self.convs, layers)):
            x = F.interpolate(x, scale_factor=self.strides[i], mode="nearest")
            x = _conv_same(x, conv, self.kernels[i], 1)
            if j < n - 1:
                x = F.leaky_relu(x, self.alpha)
        return x.permute(0, 2, 3, 1).to(torch.float32)


class SimpleAutoEncoder(nn.Module):
    """Encoder + decoder of `image_size` square depth images; `from_config`
    reads an encoder directory's config.yaml (config/encoder.yaml layout)."""

    def __init__(self, filters: Sequence[int] = (32, 32, 32), kernels: Sequence[int] = (7, 5, 3),
                 strides: Sequence[int] = (2, 2, 2), encoding_dim: int = 100, alpha: float = 0.1,
                 image_size: int = 64):
        super().__init__()
        down = math.prod(strides)
        self.encoder = ConvEncoder(filters, kernels, strides, encoding_dim, alpha,
                                   in_hw=(image_size, image_size))
        self.decoder = ConvDecoder(filters, kernels, strides, encoding_dim, alpha,
                                   base_hw=image_size // down)

    @classmethod
    def from_config(cls, config, image_size=64):
        net = config["network"]
        return cls(filters=[int(l["filters"]) for l in net],
                   kernels=[int(l["kernel_size"]) for l in net],
                   strides=[int(l["strides"]) for l in net],
                   encoding_dim=int(config["encoding_dim"]),
                   alpha=float(config.get("alpha", 0.1)), image_size=image_size)

    def forward(self, x):
        return self.decoder(self.encoder(x))

    def encode(self, x):
        return self.encoder(x)


@torch.no_grad()
def init_params_(model: nn.Module, gen: torch.Generator):
    """Flax's default initialization, drawn from `gen`: every conv and
    dense kernel LeCun-normal (variance 1 / fan_in, a normal truncated at
    +-2 standard deviations and rescaled to that variance), every bias 0.
    Returns `model`."""
    # std of a unit normal truncated to [-2, 2] (jax.nn.initializers)
    trunc_std = 0.87962566103423978
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / trunc_std
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            m.bias.zero_()
    return model


def create_ae_train_state(model: nn.Module, gen: torch.Generator, learning_rate=2e-4):
    """Flax-initialized parameters (from `gen`) and the Adam of
    `optax.adam(learning_rate)` over them. Returns the optimizer."""
    init_params_(model, gen)
    return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def ae_train_step(model: nn.Module, opt: torch.optim.Optimizer, batch):
    """One training step on the mean squared reconstruction error of
    (B, H, W, 1) `batch`; returns the loss before the step."""
    opt.zero_grad(set_to_none=True)
    loss = torch.mean((model(batch) - batch) ** 2)
    loss.backward()
    opt.step()
    return loss.detach()


def load_encoder_config(path):
    if path and os.path.exists(cfg_util.resolve_path(path)):
        return io_utils.load_yaml(cfg_util.resolve_path(path))
    return dict(DEFAULT_ENCODER_CONFIG)


def build_model(enc_cfg) -> ConvEncoder:
    """The encoder half of `SimpleAutoEncoder.from_config` (autoencoder.py:82)
    for 64 x 64 images; the leaky-ReLU slope defaults to 0.1, as no shipped
    config sets it."""
    net = enc_cfg["network"]
    return ConvEncoder(filters=[int(l["filters"]) for l in net],
                       kernels=[int(l["kernel_size"]) for l in net],
                       strides=[int(l["strides"]) for l in net],
                       encoding_dim=int(enc_cfg["encoding_dim"]),
                       alpha=float(enc_cfg.get("alpha", 0.1)))


def _half_state_dict(half: dict, prefix: str) -> dict:
    """One half of Flax autoencoder params -> state_dict entries under
    `prefix`: HWIO conv kernels to OIHW, (in, out) dense kernels to
    (out, in). Dense rows and columns keep their NHWC order, which is the
    order of the port's flatten and reshape."""
    out = {}
    for name, layer in half.items():
        conv = re.fullmatch(r"Conv_(\d+)", name)
        if conv:
            key, kernel = f"convs.{conv.group(1)}.", np.transpose(layer["kernel"], (3, 2, 0, 1))
        elif name == "Dense_0":
            key, kernel = "dense.", np.transpose(layer["kernel"])
        else:
            raise ValueError(f"unknown layer {name!r}")
        if set(layer) != {"kernel", "bias"}:
            raise ValueError(f"layer {name!r} holds {sorted(layer)}")
        out[prefix + key + "weight"] = kernel
        out[prefix + key + "bias"] = layer["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def encoder_state_dict(params: dict) -> dict:
    """The `encoder` half of Flax autoencoder params -> a `ConvEncoder`
    state_dict. Every `encoder/*` array is used; any other layer name is
    refused."""
    return _half_state_dict(params["encoder"], "")


def ae_state_dict(params: dict) -> dict:
    """Flax autoencoder params -> a `SimpleAutoEncoder` state_dict."""
    return {**_half_state_dict(params["encoder"], "encoder."),
            **_half_state_dict(params["decoder"], "decoder.")}


def _load_params(model_dir):
    with np.load(os.path.join(model_dir, "weights.npz"), allow_pickle=True) as f:
        return f["params"].item()


def load_trained_encoder(model_dir, device="cpu") -> ConvEncoder:
    """The trained encoder of `model_dir` on `device`, frozen: a batched
    encode, (B, 64, 64, 1) depth images -> (B, encoding_dim) latents."""
    model = build_model(load_encoder_config(os.path.join(model_dir, "config.yaml")))
    model.load_state_dict(encoder_state_dict(_load_params(model_dir)), strict=True)
    return model.to(device).eval().requires_grad_(False)


def load_trained_autoencoder(model_dir, device="cpu") -> SimpleAutoEncoder:
    """The whole trained autoencoder of `model_dir` on `device`, frozen."""
    model = SimpleAutoEncoder.from_config(
        load_encoder_config(os.path.join(model_dir, "config.yaml")))
    model.load_state_dict(ae_state_dict(_load_params(model_dir)), strict=True)
    return model.to(device).eval().requires_grad_(False)


@torch.no_grad()


def encoder_for_config(config, device):
    """The trained encoder for encoder-latent observations (the
    EncodedDepthImgSensor's weights, reference sensor.py:186-196; the JAX
    package's trainer.py:68-87 `_maybe_load_encoder`), on
    `device`; None for image observations. Refuses when
    `sensor.encoder_dir` is unset or holds no `weights.npz`."""
    if config.get("depth_observation") or config.get("full_observation"):
        return None
    enc_dir = config.get("sensor", {}).get("encoder_dir")
    if not enc_dir:
        raise ValueError("encoder-latent observations need sensor.encoder_dir (a trained "
                         "encoder such as encoder_files/full_r4); the port has no stand-in")
    path = cfg_util.resolve_path(enc_dir)
    if not os.path.exists(os.path.join(path, "weights.npz")):
        raise ValueError(f"sensor.encoder_dir {enc_dir} ({path}) holds no weights.npz; the "
                         "port has no stand-in for a missing encoder")
    return load_trained_encoder(path, device)
