"""State and parameter containers for the batched rigid-body world.

Port of deep_rl_grasping_tpu/sim/types.py. The JAX package keeps one env's
state as a pytree and adds the env axis with `vmap`; here every state field
carries the env axis B first, and a batch of envs is one `SimState`.

Gripper model (reference: models/gripper/wsg50_one_motor_gripper_new.sdf,
flying WSG-50): reduced coordinates q = [x, y, z, yaw, f_left, f_right].
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

# Finger joint geometry (from the WSG-50 SDF link poses):
FINGER_LIMIT_LOW = -0.01
FINGER_LIMIT_HIGH = 0.05
FINGER_OPEN = 0.0
FINGER_CLOSED = 0.05
PAD_X_OFFSET = 0.062
PAD_HALF_EXTENTS = (0.010, 0.010, 0.075)
PAD_CENTER_DEPTH = 0.187  # pads span [0.112, 0.262] below the base link
BASE_HALF_EXTENTS = (0.025, 0.025, 0.055)
BASE_CENTER_DEPTH = 0.055


class _Replace:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class GripperState(_Replace):
    q: torch.Tensor              # (B, 6) [x, y, z, yaw, f_l, f_r]
    qd: torch.Tensor             # (B, 6)
    target: torch.Tensor         # (B, 4) servo targets for x, y, z, yaw
    finger_target: torch.Tensor  # (B,) FINGER_OPEN or FINGER_CLOSED
    gripper_close: torch.Tensor  # (B,) bool latch
    ee_angle: torch.Tensor       # (B,) accumulated endEffectorAngle


@dataclass
class ObjectState(_Replace):
    pos: torch.Tensor       # (B, K, 3) COM position, world
    quat: torch.Tensor      # (B, K, 4) [x,y,z,w]
    linvel: torch.Tensor    # (B, K, 3)
    angvel: torch.Tensor    # (B, K, 3) world frame
    obj_type: torch.Tensor  # (B, K) int64 index into the ObjectLibrary
    alive: torch.Tensor     # (B, K) bool


@dataclass
class SimState(_Replace):
    gripper: GripperState
    objects: ObjectState


def tree_map(fn, *trees):
    """Apply `fn` leafwise over matching dataclass trees of tensors."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)
        })
    return fn(*trees)


def tree_where(mask, a, b):
    """Per-env select: mask (B,) bool picks leaves of `a`, else of `b`."""
    def sel(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        return torch.where(m, x, y)
    return tree_map(sel, a, b)


_BOOL_FIELDS = {"gripper_close", "alive"}
_INT_FIELDS = {"obj_type"}


def sim_state_from_numpy(arrays: dict, device="cpu") -> SimState:
    """Build a SimState from a flat dict of numpy arrays keyed like
    `gripper.q` / `objects.pos` (the JAX package's field names)."""
    def conv(name, a):
        a = np.asarray(a)
        if name in _BOOL_FIELDS:
            return torch.as_tensor(a.astype(bool), device=device)
        if name in _INT_FIELDS:
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(a.astype(np.float32), device=device)

    g = {f.name: conv(f.name, arrays["gripper." + f.name])
         for f in dataclasses.fields(GripperState)}
    o = {f.name: conv(f.name, arrays["objects." + f.name])
         for f in dataclasses.fields(ObjectState)}
    return SimState(gripper=GripperState(**g), objects=ObjectState(**o))


def sim_state_to_numpy(state: SimState) -> dict:
    out = {}
    for part in ("gripper", "objects"):
        sub = getattr(state, part)
        for f in dataclasses.fields(sub):
            out[f"{part}.{f.name}"] = getattr(sub, f.name).detach().cpu().numpy()
    return out


@dataclass
class SimParams(_Replace):
    """Physics parameters. Scalars are Python numbers (the solver kernel
    receives them by value); per-DOF and library arrays are tensors on the
    device the simulation runs on."""
    dt: float = 1.0 / 240.0
    solver_iterations: int = 8
    support_z: float = 0.0
    has_tray: bool = False
    tray_half: float = 0.21
    tray_wall_height: float = 0.062
    friction: float = 1.0
    baumgarte: float = 0.2
    slop: float = 1e-4
    relaxation: float = 0.35
    gravity: float = -9.81
    lin_damping: float = 0.2
    ang_damping: float = 1.0
    dof_mass: tuple = (6.0, 6.0, 6.0, 0.1, 0.4, 0.4)
    dof_force: tuple = (100.0, 100.0, 100.0, 20.0, 50.0, 50.0)
    dof_vmax: tuple = (1.5, 1.5, 1.5, 6.0, 0.25, 0.25)
    max_bias_velocity: float = 1.0
    warm_start: float = 0.95
    pad_inner_iterations: int = 14
    # Rolling resistance at static contacts (types.py:119 default 0.1).
    rolling_damping: float = 0.1
    # In-hand spin resistance (types.py:127 default off).
    pinch_damping: float = 0.0
    # Object-object cost knobs (types.py:140-145).
    oo_point_mass_tangent: bool = False
    oo_pass_stride: int = 1
    pad_omega: float = 0.4
    pad_bias_scale: float = 0.1
    # Object library (dense tensors)
    centers: torch.Tensor = None      # (T, S, 3)
    radii: torch.Tensor = None        # (T, S)
    oo_centers: torch.Tensor = None   # (T, SC, 3)
    oo_radii: torch.Tensor = None     # (T, SC)
    inv_mass: torch.Tensor = None     # (T,)
    inv_inertia: torch.Tensor = None  # (T, 3)
    color: torch.Tensor = None        # (T, 3)
    bound_radius: torch.Tensor = None  # (T,)
    device: str = field(default="cpu")

    def dof(self, name):
        return torch.tensor(getattr(self, name), dtype=torch.float32, device=self.device)


def make_sim_params(library, scene_type="OnTable", device="cpu", **overrides):
    support_z = -0.19 if scene_type == "OnTable" else -0.196

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SimParams(
        support_z=support_z,
        has_tray=(scene_type == "OnTable"),
        centers=t(library.centers),
        radii=t(library.radii),
        oo_centers=t(library.oo_centers),
        oo_radii=t(library.oo_radii),
        inv_mass=t(library.inv_mass),
        inv_inertia=t(library.inv_inertia),
        color=t(library.color),
        bound_radius=t(library.bound_radius),
        device=str(device),
        **overrides,
    )
