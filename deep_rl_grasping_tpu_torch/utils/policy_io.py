"""Carry policy weights between the JAX package's bundles and the port.

Reads the committed `trained/*/policy.npz` bundles (written by the JAX
package's utils/policy_io.py, arrays keyed by Flax key path such as
`policy['MLP_0']['Dense_0']['kernel']`, policy_io.py:28-31,79) into a
`SACActor`, `QNetwork` or `BDQNetwork` state_dict and a
`NormalizerState`. Layout changes:

* Dense kernels are (in, out) in Flax and (out, in) in torch: transposed.
* Conv kernels are HWIO in Flax and OIHW in torch: permuted.
* The 512-wide dense layer after the convolutions (networks.py:45) sees an
  NHWC flatten in Flax and an NCHW flatten in the port, so its input rows
  are reordered from (h, w, c) to (c, h, w).

Flax names a layer when the layer is built, not when it is applied
(networks.py:129-181). In `QNetwork`, `Dense(A)(relu(Dense(64)(h)))`
builds the outer layer first: `Dense_0` is the advantage output,
`Dense_1` the 64-wide layer under it, `Dense_2` / `Dense_3` the same for
the value. In `BDQNetwork`, `MLP_0` is the trunk, `MLP_1` + `Dense_0` the
value stream and `MLP_{2+d}` + `Dense_{1+d}` branch d. The value and
branch MLPs have the same shapes, so only the order tells them apart.

`actor_state_dict`, `critic_state_dict` and `q_state_dict` take plain
nested dicts of numpy arrays in the Flax layout too; `load_sac_state`
carries a whole Flax `SACState` (actor, critic, target critic, log_alpha)
into the port's SAC and `load_q_state` a `DQNState` / `BDQState` (params,
target params) into the port's DQN / BDQ, which is how the tests hand them
freshly initialised Flax params.

`save_policy` writes the other way (utils/policy_io.py:34-47 of the JAX
package): a port-trained network and its normalizer moments as a
`policy.npz` under the JAX key paths, with the `__meta__` JSON, which the
JAX package's `train.py run --npz` reads. One `layout` table per network
drives both directions.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from deep_rl_grasping_tpu_torch.algos.normalize import NormalizerState, RunningMeanStd
from deep_rl_grasping_tpu_torch.models.networks import (
    BDQNetwork,
    QNetwork,
    SACActor,
    SACCritic,
)

_KEY = re.compile(r"\['([^']+)'\]")
FORMAT_VERSION = 1


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, arr in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return out


def _mlp(mlp, flax, prefix):
    return [(flax + (f"Dense_{i}",), f"{prefix}layers.{i}.", "dense")
            for i in range(len(mlp.layers))]


def _torso(torso, prefix):
    """Layout of a torso (the augmented Nature CNN or an MLP) and the index
    of the first Flax `MLP_<i>` after it."""
    if not hasattr(torso, "cnn"):
        return _mlp(torso, ("MLP_0",), prefix), 1
    cnn = ("AugmentedNatureCNN_0", "NatureCNN_0")
    out = [(cnn + (f"Conv_{i}",), f"{prefix}cnn.convs.{i}.", "conv")
           for i in range(len(torso.cnn.convs))]
    out.append((cnn + ("Dense_0",), f"{prefix}cnn.dense.", ("flat_dense", torso.cnn.out_chw)))
    return out, 0


def layout(module):
    """Where each layer of a `SACActor`, `SACCritic`, `QNetwork` or
    `BDQNetwork` sits in the Flax param tree: (Flax path, torch prefix,
    kind) per layer, in the creation order described above."""
    if isinstance(module, SACActor):
        out, i = _torso(module.torso, "torso.")
        if module.mlp is not None:
            out += _mlp(module.mlp, (f"MLP_{i}",), "mlp.")
        return out + [(("Dense_0",), "mean.", "dense"), (("Dense_1",), "log_std.", "dense")]
    if isinstance(module, SACCritic):
        out, i = _torso(module.torso, "torso.")
        for q in range(2):
            out += _mlp(module.mlps[q], (f"MLP_{i + q}",), f"mlps.{q}.")
            out.append(((f"Dense_{q}",), f"heads.{q}.", "dense"))
        return out
    if isinstance(module, BDQNetwork):
        out = _torso(module.cnn, "cnn.")[0] if module.cnn is not None else []
        out += _mlp(module.trunk, ("MLP_0",), "trunk.")
        out += _mlp(module.value_mlp, ("MLP_1",), "value_mlp.")
        out.append((("Dense_0",), "value.", "dense"))
        for d in range(len(module.branches)):
            out += _mlp(module.branch_mlps[d], (f"MLP_{2 + d}",), f"branch_mlps.{d}.")
            out.append(((f"Dense_{1 + d}",), f"branches.{d}.", "dense"))
        return out
    if isinstance(module, QNetwork):
        out, i = _torso(module.torso, "torso.")
        if module.mlp is not None:
            out += _mlp(module.mlp, (f"MLP_{i}",), "mlp.")
        heads = ("adv", "adv_hidden") + (("val", "val_hidden") if module.dueling else ())
        return out + [((f"Dense_{j}",), f"{name}.", "dense") for j, name in enumerate(heads)]
    raise TypeError(f"no Flax layout for {type(module).__name__}")


def _to_torch(kernel, kind):
    k = np.asarray(kernel, np.float32)
    if kind == "dense":
        return k.T
    if kind == "conv":  # HWIO -> OIHW
        return k.transpose(3, 2, 0, 1)
    c, h, w = kind[1]  # rows in NHWC flatten order -> NCHW
    return k.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(c * h * w, -1).T


def _to_flax(weight, kind):
    w = np.asarray(weight, np.float32)
    if kind == "dense":
        return w.T
    if kind == "conv":  # OIHW -> HWIO
        return w.transpose(2, 3, 1, 0)
    c, h, w_ = kind[1]
    return w.T.reshape(c, h, w_, -1).transpose(1, 2, 0, 3).reshape(h * w_ * c, -1)


def _state_dict(params: dict, module) -> dict:
    out = {}
    for path, prefix, kind in layout(module):
        node = params
        for p in path:
            if not isinstance(node, dict) or p not in node:
                raise ValueError(f"the params hold no {'/'.join(path)} for "
                                 f"{type(module).__name__}.{prefix[:-1]}")
            node = node[p]
        out[prefix + "weight"] = _to_torch(node["kernel"], kind)
        out[prefix + "bias"] = np.asarray(node["bias"], np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def flax_params(state_dict, module) -> dict:
    """The inverse of the maps below: a torch state_dict of `module` ->
    Flax params (nested dict of float32 numpy arrays: Dense kernels
    (in, out), Conv kernels HWIO, the 512-wide layer's rows in NHWC
    flatten order)."""
    params: dict = {}
    for path, prefix, kind in layout(module):
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node["kernel"] = _to_flax(state_dict[prefix + "weight"].detach().cpu(), kind)
        node["bias"] = np.asarray(state_dict[prefix + "bias"].detach().cpu(), np.float32)
    return params


def actor_state_dict(params: dict, actor: SACActor) -> dict:
    """Flax SACActor params (nested dict of arrays) -> torch state_dict."""
    return _state_dict(params, actor)


def critic_state_dict(params: dict, critic: SACCritic) -> dict:
    """Flax SACCritic params (nested dict of arrays) -> torch state_dict:
    the torso, then per Q head the Flax MLP_<i> and Dense_<j> in creation
    order (networks.py:112-126)."""
    return _state_dict(params, critic)


def q_state_dict(params: dict, net) -> dict:
    """Flax QNetwork or BDQNetwork params (nested dict of arrays) -> torch
    state_dict of the port's `QNetwork` or `BDQNetwork`, by the creation
    order described above."""
    if not isinstance(net, (QNetwork, BDQNetwork)):
        raise TypeError(f"not a Q network: {type(net).__name__}")
    return _state_dict(params, net)


def _n_arrays(tree) -> int:
    return sum(_n_arrays(v) for v in tree.values()) if isinstance(tree, dict) else 1


def _policy_state_dict(params: dict, module) -> dict:
    """Flax policy params -> `module`'s state_dict; refuses params with an
    array the module has no place for."""
    sd = _state_dict(params, module)
    if len(sd) != _n_arrays(params):
        raise ValueError(f"the bundle holds {_n_arrays(params)} policy arrays, "
                         f"{type(module).__name__} takes {len(sd)}")
    return sd


def _load_strict(module, sd):
    own = module.state_dict()
    for k, v in sd.items():
        if k not in own or tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"param {k}: shape {tuple(v.shape)} does not fit the module "
                             f"({tuple(own[k].shape) if k in own else 'missing'})")
    module.load_state_dict(sd, strict=True)
    return module


def load_actor_params(actor: SACActor, params: dict):
    """Load Flax-layout params into `actor` (strict: every key must match)."""
    return _load_strict(actor, actor_state_dict(params, actor))


def load_sac_state(sac, actor_params, critic_params, target_critic_params, log_alpha):
    """Carry a whole Flax `SACState` across: actor, critic, target critic
    (Flax param trees as nested dicts of numpy arrays) and log_alpha into
    `sac` (algos.sac.SAC). The Adam moments start at zero, as a fresh optax
    state has them."""
    dev = sac.log_alpha.device
    _load_strict(sac.actor, actor_state_dict(actor_params, sac.actor)).to(dev)
    _load_strict(sac.critic, critic_state_dict(critic_params, sac.critic)).to(dev)
    _load_strict(sac.target_critic,
                 critic_state_dict(target_critic_params, sac.target_critic)).to(dev)
    with torch.no_grad():
        sac.log_alpha.fill_(float(np.asarray(log_alpha)))
    sac.reset_optimizers()
    return sac


def load_q_state(learner, params, target_params):
    """Carry a Flax `DQNState` / `BDQState` across: params and target params
    (nested dicts of numpy arrays) into `learner` (algos.dqn.DQN or
    algos.bdq.BDQ), with a fresh Adam and the update count at 0."""
    dev = learner.device
    _load_strict(learner.net, q_state_dict(params, learner.net)).to(dev)
    _load_strict(learner.target_net, q_state_dict(target_params, learner.target_net)).to(dev)
    learner.step = 0
    learner.reset_optimizer()
    return learner


def read_bundle(npz_dir):
    """Read <npz_dir>/policy.npz into (nested policy params, obs_rms dict,
    ret_rms dict, meta)."""
    data = np.load(os.path.join(npz_dir, "policy.npz"))
    meta = json.loads(bytes(data["__meta__"]).decode())
    policy, rms = {}, {"obs_rms": {}, "ret_rms": {}}
    for key in data.files:
        if key.startswith("policy"):
            policy[tuple(_KEY.findall(key))] = data[key]
        elif key.split(".")[0] in rms:
            group, field = key.split(".", 1)
            rms[group][field] = data[key]
    return _nest(policy), rms["obs_rms"], rms["ret_rms"], meta


BUNDLE_KINDS = {SACActor: ("SAC", "actor_params"), QNetwork: ("DQN", "params"),
                BDQNetwork: ("BDQ", "params")}


def load_policy(npz_dir, actor, device="cpu"):
    """Load a committed bundle into `actor` (a SACActor, QNetwork or
    BDQNetwork, which must match the bundle's algorithm); every array is
    used and the load is strict. Returns (actor, NormalizerState with the
    bundle's moments, meta)."""
    policy, obs_rms, ret_rms, meta = read_bundle(npz_dir)
    algo, field = BUNDLE_KINDS[type(actor)]
    if meta.get("algo") != algo or meta.get("params_field") != field:
        raise ValueError(f"bundle meta {meta} is not a {algo} bundle")
    _load_strict(actor, _policy_state_dict(policy, actor))
    actor.to(device)

    def rms(d, shape):
        got = tuple(np.shape(d["mean"]))
        if got != tuple(shape):
            raise ValueError(f"bundle moments have shape {got}, expected {tuple(shape)}")
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return RunningMeanStd(mean=t(d["mean"]), var=t(d["var"]), count=t(d["count"]))

    norm = NormalizerState(obs_rms=rms(obs_rms, actor.obs_shape), ret_rms=rms(ret_rms, ()),
                           returns=torch.zeros(0, device=device))
    return actor, norm, meta


def _flat_keys(prefix, tree):
    """Flax key paths as jax.tree_util.keystr writes them for nested dicts."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        out.update(_flat_keys(key, v) if isinstance(v, dict) else {key: v})
    return out


def save_policy(out_dir, net, obs_rms, ret_rms, meta=None):
    """Write <out_dir>/policy.npz for `net` (a SACActor, QNetwork or
    BDQNetwork) and the normalizer moments `obs_rms`, `ret_rms`
    (RunningMeanStd or dicts of mean, var, count), in the JAX package's
    layout: `policy[...]` arrays by Flax key path, `obs_rms.mean` and the
    like, and `__meta__` (sorted-key JSON of `meta` with the bundle's
    `algo`, `params_field` and `format_version` 1). Returns the path."""
    algo, field = BUNDLE_KINDS[type(net)]
    arrays = _flat_keys("policy", flax_params(net.state_dict(), net))
    for name, rms in (("obs_rms", obs_rms), ("ret_rms", ret_rms)):
        for k in ("mean", "var", "count"):
            v = rms[k] if isinstance(rms, dict) else getattr(rms, k)
            arrays[f"{name}.{k}"] = np.asarray(torch.as_tensor(v).detach().cpu(), np.float32)
    meta = dict(meta or {}, algo=algo, params_field=field, format_version=FORMAT_VERSION)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta, sort_keys=True).encode(),
                                       dtype=np.uint8).copy()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "policy.npz")
    np.savez_compressed(path, **arrays)
    return path
