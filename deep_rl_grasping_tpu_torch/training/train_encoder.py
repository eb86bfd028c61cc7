"""Loading a trained depth-image encoder (port of the loader half of
deep_rl_grasping_tpu/training/train_encoder.py: `load_encoder_config` :45,
`build_model` :51, `load_trained_encoder` :55).

An encoder directory (`encoder_files/<name>/`) holds the autoencoder's
`config.yaml` and `weights.npz`, which is one pickled object array,
`params`: the Flax autoencoder's nested dict of plain numpy arrays,
`encoder/{Conv_0,Conv_1,Conv_2,Dense_0}/{kernel,bias}` and `decoder/...`.
Evaluation and training on latents use the encoder half only.

The autoencoder's training CLI (train / test / visualize) is not ported
yet.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from deep_rl_grasping_tpu_torch.models.autoencoder import ConvEncoder
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils

# the architecture part of the JAX package's DEFAULT_ENCODER_CONFIG (:33),
# used when an encoder directory has no config.yaml
DEFAULT_ENCODER_CONFIG = {
    "network": [
        {"filters": 32, "kernel_size": 7, "strides": 2},
        {"filters": 32, "kernel_size": 5, "strides": 2},
        {"filters": 32, "kernel_size": 3, "strides": 2},
    ],
    "encoding_dim": 100,
}


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


def encoder_state_dict(params: dict) -> dict:
    """The `encoder` half of Flax autoencoder params -> a `ConvEncoder`
    state_dict: HWIO conv kernels to OIHW, (in, out) dense kernels to
    (out, in). The dense rows keep their NHWC order, which is the order of
    the port's flatten. Every `encoder/*` array is used; any other layer
    name is refused."""
    out = {}
    for name, layer in params["encoder"].items():
        conv = re.fullmatch(r"Conv_(\d+)", name)
        if conv:
            prefix, kernel = f"convs.{conv.group(1)}.", np.transpose(layer["kernel"], (3, 2, 0, 1))
        elif name == "Dense_0":
            prefix, kernel = "dense.", np.transpose(layer["kernel"])
        else:
            raise ValueError(f"unknown encoder layer {name!r}")
        if set(layer) != {"kernel", "bias"}:
            raise ValueError(f"encoder layer {name!r} holds {sorted(layer)}")
        out[prefix + "weight"] = kernel
        out[prefix + "bias"] = layer["bias"]
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def load_trained_encoder(model_dir, device="cpu") -> ConvEncoder:
    """The trained encoder of `model_dir` on `device`, frozen: a batched
    encode, (B, 64, 64, 1) depth images -> (B, encoding_dim) latents."""
    model = build_model(load_encoder_config(os.path.join(model_dir, "config.yaml")))
    with np.load(os.path.join(model_dir, "weights.npz"), allow_pickle=True) as f:
        params = f["params"].item()
    model.load_state_dict(encoder_state_dict(params), strict=True)
    return model.to(device).eval().requires_grad_(False)
