"""How the DQN and BDQ bundles' protocol scores move under float32
rounding, on the card.

    python3 -m deep_rl_grasping_tpu_torch.tools.q_bundle_probe --out DIR

Each bundle is evaluated on the 100-episode protocol from the JAX
package's validation scenes of these bundles (deep_rl_grasping_tpu_torch/
data/simplified_r5_val_scenes.npz) under variants of the port that
compute the same functions with other rounding:

* `kernels`: the port as it runs (twice, and once from torch-drawn scenes);
* `tpu_default_heads`: every float32 `nn.Linear` outside the bfloat16 MLPs
  fed bfloat16-rounded inputs and weights (float32 accumulation and
  bias), as a TPU's default matrix-product precision computes the Q
  networks' float32 heads (deep_rl_grasping_tpu/models/networks.py:129-181)
  where the bundles' PROVENANCE.md figures were taken;
* `plain_solver`: the solver's plain PyTorch version (sim/physics.run) on
  the card instead of the CUDA kernel;
* `plain_raster`: the raster's plain version (render/raycast.render)
  instead of the CUDA kernel;
* `float32_encoder`: the encoder's convolutions and dense layer in float32
  instead of bfloat16;

and then, with the kernels, from the same scenes with every object
position moved by one float32 ulp in a random direction (ULP_DRAWS draws
per bundle), which spreads the scores as far as rounding alone can.

The DQN bundle's dueling heads leave the top two actions within ~1e-3 of
each other on many states (tests/test_torch_discrete.py), so a rounding
difference anywhere upstream can change its greedy action. It prints one
JSON line per bundle and variant, with the card's name, and writes them to
DIR/q_bundle_probe.jsonl.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

BUNDLES = (os.path.join("trained", "bdq_simplified_r5"),
           os.path.join("trained", "dqn_simplified_r5"))
SCENES = os.path.join("deep_rl_grasping_tpu_torch", "data", "simplified_r5_val_scenes.npz")
JAX_VAL = {BUNDLES[0]: 0.68, BUNDLES[1]: 0.60}


def _round_bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def tpu_default_heads(net):
    """Round the weights of `net`'s float32 heads to bfloat16 in place and
    round their inputs on every call."""
    from deep_rl_grasping_tpu_torch.models.networks import MLP

    in_mlp = {id(m) for mlp in net.modules() if isinstance(mlp, MLP) for m in mlp.layers}
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Linear) and id(m) not in in_mlp:
                m.weight.copy_(_round_bf16(m.weight))
                m.register_forward_pre_hook(lambda _m, args: (_round_bf16(args[0]),))


def _variant(name, policy):
    """Apply variant `name` (see the module docstring); returns a function
    that undoes it."""
    from deep_rl_grasping_tpu_torch.models import autoencoder
    from deep_rl_grasping_tpu_torch.ops import raster_cuda, solver_cuda
    from deep_rl_grasping_tpu_torch.render import raycast
    from deep_rl_grasping_tpu_torch.sim import physics

    if name == "tpu_default_heads":
        tpu_default_heads(policy.net)
        return lambda: None
    mod, attr, repl = {
        "plain_solver": (solver_cuda, "run_batched_sim", physics.run),
        "plain_raster": (raster_cuda, "render_batch",
                         lambda st, p, cp, cr, intr, H, W, near, far, with_rgb=False:
                         raycast.render(st, p, cp, cr, intr, H, W, near, far, with_rgb)),
        "float32_encoder": (autoencoder, "CDTYPE", torch.float32),
        "kernels": (None, None, None),
    }[name]
    if mod is None:
        return lambda: None
    old = getattr(mod, attr)
    setattr(mod, attr, repl)
    return lambda: setattr(mod, attr, old)


VARIANTS = ("kernels", "tpu_default_heads", "plain_solver", "plain_raster", "float32_encoder")
ULP_DRAWS = 8


def ulp_moved(arrays, seed):
    """The scene arrays with each object position coordinate moved to its
    float32 neighbour above or below, at random."""
    rng = np.random.default_rng(seed)
    pos = arrays["objects.pos"].astype(np.float32)
    up = rng.random(pos.shape) < 0.5
    moved = np.where(up, np.nextafter(pos, np.float32(np.inf)),
                     np.nextafter(pos, np.float32(-np.inf)))
    return dict(arrays, **{"objects.pos": moved.astype(np.float32)})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="directory for q_bundle_probe.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("q_bundle_probe measures on the card; no CUDA device is available")
    from deep_rl_grasping_tpu_torch.envs.grasp_env import env_state_from_numpy
    from deep_rl_grasping_tpu_torch.training import train, trainer

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda")
    train.set_precision()
    with np.load(SCENES) as data:
        arrays = {k[len("scene."):]: data[k] for k in data.files if k.startswith("scene.")}

    def evaluate(config, policy, norm, scenes, scene_arrays=arrays):
        ev = trainer.Evaluator(config, dev)
        t0 = time.perf_counter()
        r = ev.evaluate(policy, norm, n_episodes=100, initial_states=(
            env_state_from_numpy(scene_arrays, dev) if scenes == "jax" else None))
        torch.cuda.synchronize()
        return dict(r, wall_seconds=time.perf_counter() - t0)

    rows = []
    for bundle in BUNDLES:
        for variant in VARIANTS:
            config, policy, norm = train.load_bundle_actor(bundle, dev)
            undo = _variant(variant, policy)
            try:
                runs = [evaluate(config, policy, norm, "jax")
                        for _ in range(2 if variant == "kernels" else 1)]
                torch_runs = [evaluate(config, policy, norm, "torch")] if variant == "kernels" \
                    else []
            finally:
                undo()
            row = {"bundle": bundle, "variant": variant, "jax_reference_val": JAX_VAL[bundle],
                   "jax_scenes_success_rate": [x["success_rate"] for x in runs],
                   "torch_scenes_success_rate": [x["success_rate"] for x in torch_runs],
                   "mean_length": runs[0]["mean_length"],
                   "wall_seconds": [x["wall_seconds"] for x in runs + torch_runs],
                   "device": torch.cuda.get_device_name(0)}
            print(json.dumps(row), flush=True)
            rows.append(row)
        config, policy, norm = train.load_bundle_actor(bundle, dev)
        sr = [evaluate(config, policy, norm, "jax", ulp_moved(arrays, k))["success_rate"]
              for k in range(ULP_DRAWS)]
        row = {"bundle": bundle, "variant": "kernels_objects_moved_1_ulp",
               "jax_reference_val": JAX_VAL[bundle], "jax_scenes_success_rate": sr,
               "mean": float(np.mean(sr)), "min": min(sr), "max": max(sr),
               "device": torch.cuda.get_device_name(0)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    with open(os.path.join(args.out, "q_bundle_probe.jsonl"), "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
