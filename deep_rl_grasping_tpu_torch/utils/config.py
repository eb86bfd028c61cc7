"""Config schema (the port's own copy of deep_rl_grasping_tpu/utils/config.py).

YAML layout mirrors the reference's config files key-for-key
(reference: config/gripper_grasp.yaml, config/simplified_object_picking.yaml)
so existing experiment configs port 1:1, with an extra optional `tpu:` block
for batching / sharding knobs that have no reference counterpart.

The resolved config stays a plain nested dict (like the reference's
io_utils.load_yaml usage); this module adds defaulting + a typed static-param
extraction used to build the jitted env.
"""

from __future__ import annotations

import copy
import os

from deep_rl_grasping_tpu_torch.utils import io_utils

_DEFAULTS = {
    "robot": {
        "model_path": "models/gripper/wsg50_one_motor_gripper_new.sdf",
        "max_translation": 0.03,
        "max_yaw_rotation": 0.15,
        "max_force": 100.0,
        "discrete": False,
        "step_size": 0.01,
        "yaw_step": 0.1,
        "num_actions_pad": 2,
        "include_robot_height": False,
    },
    "scene": {"scene_type": "OnTable", "data_set": "random_urdfs"},
    "simulation": {"real_time": False, "visualize": False},
    "sensor": {
        "camera_info": "configs/camera_info.yaml",
        "transform": "configs/camera_transform.yaml",
        "encoder_dir": None,
        "visualize": False,
        "randomize": None,
    },
    "reward": {
        "custom": False,
        "shaped": True,
        "terminal_reward": 10000.0,
        "grasp_reward": 100.0,
        "delta_z_scale": 1000.0,
        "time_penalty": 200.0,
        "table_clearing": False,
        "stalled": True,
        "lift_success": None,
    },
    "curriculum": {
        "init_lambda": 0.0,
        "n_steps": 8,
        "success_threshold": 0.7,
        "window_size": 1000,
        "extent": [0.01, 0.1],
        "robot_height": [0.15, 0.25],
        "lift_dist": [0.015, 0.1],
        "max_objects": [3, 5],
        "min_objects": [1, 1],
        "workspace": None,
        "work_height": None,
    },
    "skip_empty_initial_state": True,
    "simplified": False,
    "depth_observation": False,
    "full_observation": False,
    "discount_factor": 0.99,
    "time_horizon": 200,
    "normalize": True,
    "tpu": {
        # Env batch per device; total batch = num_envs * mesh devices.
        "num_envs": 128,
        "mesh_axis": "env",
        # Physics substeps per control "run": reference uses run(0.1s) = 24
        # substeps for moves and run(0.2s) = 48 for gripper open/close at
        # dt = 1/240 (simulation.py:37, robot.py:248,270).
        "dt": 1.0 / 240.0,
        "move_substeps": 24,
        "gripper_substeps": 48,
        "solver_iterations": 8,
        "max_objects": 5,
        "spheres_per_object": 8,
        "settle_substeps": 48,
        "obs_dtype": "float32",
    },
}


def _deep_merge(base, override):
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path_or_dict):
    """Load a YAML config (or take a dict) and fill defaults."""
    if isinstance(path_or_dict, dict):
        raw = path_or_dict
    else:
        raw = io_utils.load_yaml(path_or_dict)
    cfg = _deep_merge(_DEFAULTS, raw)
    return cfg


def repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def resolve_path(path):
    """Resolve a config-relative path against the repo root."""
    if path is None:
        return None
    path = os.path.expanduser(path)
    if os.path.isabs(path):
        return path
    cand = os.path.join(repo_root(), path)
    return cand
