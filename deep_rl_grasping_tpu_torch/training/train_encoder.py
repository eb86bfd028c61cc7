"""Training and loading the depth-image autoencoder (port of
deep_rl_grasping_tpu/training/train_encoder.py: `load_encoder_config` :45,
`build_model` :51, `load_trained_encoder` :55, `train` :69, `test` :132,
`visualize` :142 and the CLI :164).

An encoder directory (`encoder_files/<name>/`) holds the autoencoder's
`config.yaml`, `weights.npz` and, when trained here, `history.csv`. The
weights file is the JAX package's layout: one pickled object array,
`params`, the Flax autoencoder's nested dict of plain numpy arrays,
`encoder/{Conv_0,Conv_1,Conv_2,Dense_0}/{kernel,bias}` and
`decoder/{Dense_0,Conv_0,Conv_1,Conv_2}/{kernel,bias}`, HWIO conv kernels
and (in, out) dense kernels. So the JAX package's `load_trained_encoder`
reads an encoder trained by the port, and the port reads the JAX
package's. Evaluation and training on latents use the encoder half only.

`train` holds out 10% of the dataset's `train` images for validation,
shuffles with an explicit `torch.Generator`, stops after 25 epochs without
a new best validation MSE, keeps the best weights and writes one
history.csv row per epoch. `test` prints the MSE on the dataset's `test`
images. `visualize` imports matplotlib when called (the card machine has
none).

    python -m deep_rl_grasping_tpu_torch.training.train_encoder train \\
        --data encoder_files/dataset.npz --model_dir encoder_files/<name>
    python -m deep_rl_grasping_tpu_torch.training.train_encoder test \\
        --data encoder_files/dataset.npz --model_dir encoder_files/<name>

All three run on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import time

import numpy as np
import torch

from deep_rl_grasping_tpu_torch.models import autoencoder as ae
from deep_rl_grasping_tpu_torch.models.autoencoder import ConvEncoder
from deep_rl_grasping_tpu_torch.utils import config as cfg_util
from deep_rl_grasping_tpu_torch.utils import io_utils

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
VAL_FRACTION = 10  # one image in 10 is held out (encoders.py:46-48)
PATIENCE = 25      # epochs without a new best validation MSE before stopping
EVAL_CHUNK = 512   # images per forward pass of an evaluation


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


def ae_params(model: ae.SimpleAutoEncoder) -> dict:
    """The inverse of `ae_state_dict`: the model's parameters as Flax
    autoencoder params of numpy float32 arrays (HWIO conv kernels, (in, out)
    dense kernels, Flax's creation-order layer names)."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in model.state_dict().items()}
    out = {}
    for half in ("encoder", "decoder"):
        mod = getattr(model, half)
        layers = {f"Conv_{i}": f"{half}.convs.{i}." for i in range(len(mod.convs))}
        layers["Dense_0"] = f"{half}.dense."
        out[half] = {}
        for name, key in layers.items():
            w = sd[key + "weight"]
            kernel = np.transpose(w, (2, 3, 1, 0)) if w.ndim == 4 else np.transpose(w)
            out[half][name] = {"kernel": np.ascontiguousarray(kernel), "bias": sd[key + "bias"]}
    return out


def save_weights(model: ae.SimpleAutoEncoder, path):
    """`weights.npz` in the JAX package's layout (train_encoder.py:118-123)."""
    np.savez(path, params=np.asarray(ae_params(model), dtype=object))


def _load_params(model_dir):
    with np.load(os.path.join(model_dir, "weights.npz"), allow_pickle=True) as f:
        return f["params"].item()


def load_trained_encoder(model_dir, device="cpu") -> ConvEncoder:
    """The trained encoder of `model_dir` on `device`, frozen: a batched
    encode, (B, 64, 64, 1) depth images -> (B, encoding_dim) latents."""
    model = build_model(load_encoder_config(os.path.join(model_dir, "config.yaml")))
    model.load_state_dict(encoder_state_dict(_load_params(model_dir)), strict=True)
    return model.to(device).eval().requires_grad_(False)


def load_trained_autoencoder(model_dir, device="cpu") -> ae.SimpleAutoEncoder:
    """The whole trained autoencoder of `model_dir` on `device`, frozen."""
    model = ae.SimpleAutoEncoder.from_config(
        load_encoder_config(os.path.join(model_dir, "config.yaml")))
    model.load_state_dict(ae_state_dict(_load_params(model_dir)), strict=True)
    return model.to(device).eval().requires_grad_(False)


@torch.no_grad()
def mse(model, x):
    """Mean squared reconstruction error of images `x` (N, H, W, 1), in
    chunks of EVAL_CHUNK images."""
    total = 0.0
    for i in range(0, x.shape[0], EVAL_CHUNK):
        chunk = x[i:i + EVAL_CHUNK]
        total += float(((model(chunk) - chunk) ** 2).sum())
    return total / x[0].numel() / x.shape[0]


def _device(name):
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    return device


def _load_split(path, split, device):
    with np.load(cfg_util.resolve_path(path)) as f:
        return torch.as_tensor(np.asarray(f[split], np.float32), device=device)


def train(args):
    """Train an autoencoder on the dataset's `train` images. Returns the
    epochs run, the best validation MSE and its epoch, and timings."""
    device = _device(args.device)
    enc_cfg = load_encoder_config(args.config)
    os.makedirs(args.model_dir, exist_ok=True)
    io_utils.save_yaml(enc_cfg, os.path.join(args.model_dir, "config.yaml"))
    data = _load_split(args.data, "train", device)
    gen = torch.Generator().manual_seed(0)  # PRNGKey(0), default_rng(0)
    perm = torch.randperm(data.shape[0], generator=gen).to(device)
    n_val = max(1, data.shape[0] // VAL_FRACTION)
    val_x, trn_x = data[perm[:n_val]], data[perm[n_val:]]
    del data

    # initialized on the CPU from seed 0, so the card and the CPU start alike
    model = ae.SimpleAutoEncoder.from_config(enc_cfg)
    opt = ae.create_ae_train_state(model, torch.Generator().manual_seed(0),
                                   float(enc_cfg["learning_rate"]))
    model.to(device)
    bs = int(enc_cfg["batch_size"])
    best_val, best_epoch, bad_epochs, epochs_run = float("inf"), -1, 0, 0
    step_s, steps = 0.0, 0
    t0 = time.perf_counter()
    with open(os.path.join(args.model_dir, "history.csv"), "w", newline="") as hist_f:
        hist = csv.writer(hist_f)
        hist.writerow(["epoch", "loss", "val_loss"])
        for epoch in range(int(enc_cfg["epochs"])):
            order = torch.randperm(trn_x.shape[0], generator=gen).to(device)
            t_epoch = time.perf_counter()
            losses = [ae.ae_train_step(model, opt, trn_x[order[i:i + bs]])
                      for i in range(0, trn_x.shape[0] - bs + 1, bs)]
            tl = float(torch.stack(losses).mean())  # waits for the epoch's steps
            step_s += time.perf_counter() - t_epoch
            steps += len(losses)
            vl = mse(model, val_x)
            hist.writerow([epoch, tl, vl])
            hist_f.flush()
            print(f"epoch {epoch}: loss {tl:.6f} val {vl:.6f}", flush=True)
            epochs_run = epoch + 1
            if vl < best_val:
                best_val, best_epoch, bad_epochs = vl, epoch, 0
                save_weights(model, os.path.join(args.model_dir, "weights.npz"))
            else:
                bad_epochs += 1
                if bad_epochs >= PATIENCE:
                    print(f"early stopping at epoch {epoch}")
                    break
    print(f"best val MSE {best_val:.6f}")
    return dict(epochs=epochs_run, best_val_mse=best_val, best_epoch=best_epoch,
                train_images=int(trn_x.shape[0]), val_images=n_val, steps=steps,
                ms_per_step=step_s / max(steps, 1) * 1e3,
                wall_seconds=time.perf_counter() - t0)


def test(args):
    """The MSE of the trained autoencoder on the dataset's `test` images."""
    device = _device(args.device)
    model = load_trained_autoencoder(args.model_dir, device)
    value = mse(model, _load_split(args.data, "test", device))
    print(f"test MSE {value:.6f}")
    return value


def visualize(args):
    """Eight test images, their reconstructions and the absolute error, as
    `<model_dir>/reconstructions.png` (needs matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    device = _device(args.device)
    model = load_trained_autoencoder(args.model_dir, device)
    x = _load_split(args.data, "test", device)[:8]
    with torch.no_grad():
        recon = model(x).cpu().numpy()
    x = x.cpu().numpy()
    fig, axes = plt.subplots(3, 8, figsize=(16, 6))
    for i in range(x.shape[0]):
        axes[0, i].imshow(x[i, ..., 0], cmap="gray")
        axes[1, i].imshow(recon[i, ..., 0], cmap="gray")
        axes[2, i].imshow(np.abs(x[i, ..., 0] - recon[i, ..., 0]), cmap="hot")
    for a in axes.flat:
        a.axis("off")
    out = os.path.join(args.model_dir, "reconstructions.png")
    fig.savefig(out, dpi=100, bbox_inches="tight")
    print(f"wrote {out}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(required=True)
    for name, fn in [("train", train), ("test", test), ("visualize", visualize)]:
        sp = sub.add_parser(name)
        sp.add_argument("--config", default="configs/encoder.yaml")
        sp.add_argument("--data", default="encoder_files/dataset.npz")
        sp.add_argument("--model_dir", default="encoder_files/default")
        sp.add_argument("--device", default="cuda")
        sp.set_defaults(func=fn)
    args = p.parse_args(argv)
    if args.device == "cuda" or args.device.startswith("cuda:"):
        from deep_rl_grasping_tpu_torch.training.train import set_precision

        set_precision()
    return args.func(args)


if __name__ == "__main__":
    main()
