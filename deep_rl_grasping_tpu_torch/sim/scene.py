"""Batched scene sampling (port of deep_rl_grasping_tpu/sim/scene.py).

Randomness comes from an explicit `torch.Generator` on the simulation's
device. It cannot reproduce the JAX package's threefry stream, so the
port sees other scenes than the JAX package from the same seed; the
distribution is the same (uniform xy in the curriculum extent, uniform
random orientation, resting height, sequential-drop pile placement).
"""

from __future__ import annotations

import torch

from deep_rl_grasping_tpu_torch.ops import solver_cuda
from deep_rl_grasping_tpu_torch.sim import physics
from deep_rl_grasping_tpu_torch.sim.types import (
    FINGER_OPEN,
    GripperState,
    ObjectState,
    SimParams,
    SimState,
)
from deep_rl_grasping_tpu_torch.utils import transforms


def sample_objects(gen: torch.Generator, params: SimParams, type_ids, num_envs: int,
                   max_slots: int, min_objects: int, max_objects: int, extent: float
                   ) -> ObjectState:
    """Sample object slots for `num_envs` envs (scene.py:31).

    type_ids: (M,) candidate library ids (the dataset split)."""
    B, K = num_envs, max_slots
    dev = type_ids.device
    n = torch.randint(int(min_objects), int(max_objects) + 1, (B,), generator=gen, device=dev)
    alive = torch.arange(K, device=dev)[None, :] < n[:, None]
    t_idx = torch.randint(0, type_ids.shape[0], (B, K), generator=gen, device=dev)
    obj_type = type_ids[t_idx].long()
    xy = (torch.rand((B, K, 2), generator=gen, device=dev) * 2.0 - 1.0) * extent
    quat = transforms.random_quaternion(torch.rand((B, K, 3), generator=gen, device=dev))
    R = physics.quat_to_matrix(quat)
    local = params.centers[obj_type]
    radii = params.radii[obj_type]
    world_z = torch.einsum("bkij,bksj->bksi", R, local)[..., 2]
    lowest = torch.where(radii > 0.0, world_z - radii, torch.full_like(radii, float("inf"))).amin(-1)
    rest_z = params.support_z - lowest + 1e-4

    # Sequential-drop pile placement (scene.py:63-81): each slot is lifted
    # just enough that its bounding sphere clears every earlier alive one.
    bound = params.bound_radius[obj_type]
    z_list = []
    for k in range(K):
        zk = rest_z[:, k]
        for i in range(k):
            d2 = ((xy[:, k] - xy[:, i]) ** 2).sum(-1)
            rr = bound[:, k] + bound[:, i]
            overlap = (d2 < rr * rr) & alive[:, i]
            lift = torch.sqrt(torch.clamp(rr * rr - d2, min=0.0))
            zk = torch.where(overlap, torch.maximum(zk, z_list[i] + lift + 1e-3), zk)
        z_list.append(zk)
    pos = torch.cat([xy, torch.stack(z_list, 1)[..., None]], -1)
    zeros3 = torch.zeros((B, K, 3), device=dev)
    return ObjectState(pos=pos, quat=quat, linvel=zeros3, angvel=zeros3.clone(),
                       obj_type=obj_type, alive=alive)


def init_gripper(initial_height, num_envs: int, device) -> GripperState:
    """Gripper at (0, 0, h), yaw 0, fingers open (robot.py:124-136).
    `initial_height` is a float or a (B,) tensor."""
    q = torch.zeros((num_envs, 6), device=device)
    q[:, 4:6] = FINGER_OPEN
    q[:, 2] = torch.as_tensor(initial_height, dtype=torch.float32, device=device)
    return GripperState(
        q=q, qd=torch.zeros_like(q), target=q[:, :4].clone(),
        finger_target=torch.full((num_envs,), FINGER_OPEN, device=device),
        gripper_close=torch.zeros(num_envs, dtype=torch.bool, device=device),
        ee_angle=torch.zeros(num_envs, device=device),
    )


def _cool(objects: ObjectState) -> ObjectState:
    return objects.replace(linvel=torch.zeros_like(objects.linvel),
                           angvel=torch.zeros_like(objects.angvel))


def reset_scene(gen, params: SimParams, type_ids, num_envs: int, max_slots: int,
                min_objects: int, max_objects: int, extent: float, initial_height,
                settle_substeps: int = 48) -> SimState:
    """Fresh episodes: sampled objects, a short settle with the gripper
    parked above (in up to 4 phases with velocities zeroed between them, as
    scene.py:129-139), then the gripper spawned at `initial_height`. The
    settle goes through the solver kernel for CUDA tensors."""
    objects = sample_objects(gen, params, type_ids, num_envs, max_slots,
                             min_objects, max_objects, extent)
    dev = type_ids.device
    state = SimState(gripper=init_gripper(1.0, num_envs, dev), objects=objects)
    if settle_substeps > 0:
        phases = min(4, settle_substeps)
        per = settle_substeps // phases
        for _ in range(phases):
            state = solver_cuda.run_batched_sim(state, params, per)
            state = state.replace(objects=_cool(state.objects))
    return SimState(gripper=init_gripper(initial_height, num_envs, dev),
                    objects=_cool(state.objects))
