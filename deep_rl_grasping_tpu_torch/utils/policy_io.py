"""Carry JAX-trained policy weights into the port.

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


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, arr in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return out


def _dense(tree, prefix, out):
    out[prefix + "weight"] = np.asarray(tree["kernel"], np.float32).T
    out[prefix + "bias"] = np.asarray(tree["bias"], np.float32)


def _mlp(tree, prefix, out):
    i = 0
    while f"Dense_{i}" in tree:
        _dense(tree[f"Dense_{i}"], f"{prefix}layers.{i}.", out)
        i += 1


def _torso(params, torso, prefix, out):
    """Flax torso params -> `prefix` entries of a torch state_dict; returns
    the index of the first Flax `MLP_<i>` after the torso."""
    if not hasattr(torso, "cnn"):
        _mlp(params["MLP_0"], prefix, out)
        return 1
    cnn = params["AugmentedNatureCNN_0"]["NatureCNN_0"]
    for i in range(len(torso.cnn.convs)):
        k = np.asarray(cnn[f"Conv_{i}"]["kernel"], np.float32)  # HWIO
        out[f"{prefix}cnn.convs.{i}.weight"] = k.transpose(3, 2, 0, 1)
        out[f"{prefix}cnn.convs.{i}.bias"] = np.asarray(cnn[f"Conv_{i}"]["bias"], np.float32)
    c, h, w = torso.cnn.out_chw
    k = np.asarray(cnn["Dense_0"]["kernel"], np.float32)  # (h*w*c, F), NHWC rows
    k = k.reshape(h, w, c, -1).transpose(2, 0, 1, 3).reshape(c * h * w, -1)
    out[f"{prefix}cnn.dense.weight"] = k.T
    out[f"{prefix}cnn.dense.bias"] = np.asarray(cnn["Dense_0"]["bias"], np.float32)
    return 0


def _tensors(out):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def actor_state_dict(params: dict, actor: SACActor) -> dict:
    """Flax SACActor params (nested dict of arrays) -> torch state_dict."""
    out = {}
    i = _torso(params, actor.torso, "torso.", out)
    if actor.mlp is not None:
        _mlp(params[f"MLP_{i}"], "mlp.", out)
    _dense(params["Dense_0"], "mean.", out)
    _dense(params["Dense_1"], "log_std.", out)
    return _tensors(out)


def critic_state_dict(params: dict, critic: SACCritic) -> dict:
    """Flax SACCritic params (nested dict of arrays) -> torch state_dict:
    the torso, then per Q head the Flax MLP_<i> and Dense_<j> in creation
    order (networks.py:112-126)."""
    out = {}
    i = _torso(params, critic.torso, "torso.", out)
    for q in range(2):
        _mlp(params[f"MLP_{i + q}"], f"mlps.{q}.", out)
        _dense(params[f"Dense_{q}"], f"heads.{q}.", out)
    return _tensors(out)


def q_state_dict(params: dict, net) -> dict:
    """Flax QNetwork or BDQNetwork params (nested dict of arrays) -> torch
    state_dict of the port's `QNetwork` or `BDQNetwork`, by the creation
    order described above."""
    out = {}
    if isinstance(net, BDQNetwork):
        if net.cnn is not None:
            _torso(params, net.cnn, "cnn.", out)
        _mlp(params["MLP_0"], "trunk.", out)
        _mlp(params["MLP_1"], "value_mlp.", out)
        _dense(params["Dense_0"], "value.", out)
        for d in range(len(net.branches)):
            _mlp(params[f"MLP_{2 + d}"], f"branch_mlps.{d}.", out)
            _dense(params[f"Dense_{1 + d}"], f"branches.{d}.", out)
        return _tensors(out)
    if not isinstance(net, QNetwork):
        raise TypeError(f"not a Q network: {type(net).__name__}")
    i = _torso(params, net.torso, "torso.", out)
    if net.mlp is not None:
        _mlp(params[f"MLP_{i}"], "mlp.", out)
    heads = ("adv", "adv_hidden") + (("val", "val_hidden") if net.dueling else ())
    for j, name in enumerate(heads):
        _dense(params[f"Dense_{j}"], f"{name}.", out)
    return _tensors(out)


def _n_arrays(tree) -> int:
    return sum(_n_arrays(v) for v in tree.values()) if isinstance(tree, dict) else 1


def _policy_state_dict(params: dict, module) -> dict:
    """Flax policy params -> `module`'s state_dict; refuses params with an
    array the module has no place for."""
    if isinstance(module, SACActor):
        sd = actor_state_dict(params, module)
    else:
        sd = q_state_dict(params, module)
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
