"""Batched ray-cast depth / segmentation renderer (plain PyTorch).

Port of deep_rl_grasping_tpu/render/raycast.py (`render` :101,
`camera_pose_from_gripper` :240, `object_visible` :258) with the env axis
written out. This is the plain version of the raster kernel
(ops/raster_cuda.py, csrc/raster.cu). Depth and segmentation only; the RGB
shade path waits for the RGB-D slice.

Segmentation ids follow the JAX package:
  OnFloor:  plane=0, object slot k -> 1+k, gripper=K+1
  OnTable:  plane=0, table=1, tray=2, object slot k -> 3+k, gripper=K+3
"""

from __future__ import annotations

import torch

from deep_rl_grasping_tpu_torch.sim import physics
from deep_rl_grasping_tpu_torch.sim.types import (
    BASE_CENTER_DEPTH,
    BASE_HALF_EXTENTS,
    PAD_HALF_EXTENTS,
    SimParams,
    SimState,
)


def camera_rays(height, width, intrinsics):
    """Camera-frame ray directions with z = 1, (B, H*W, 3), from per-env
    intrinsics (B, 4) = (fx, fy, cx, cy). Ray parameter t == metric depth."""
    dev = intrinsics.device
    fx, fy, cx, cy = (intrinsics[:, i, None, None] for i in range(4))
    u = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    v = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    x = (u[None, None, :] - cx) / fx
    y = (v[None, :, None] - cy) / fy
    B = intrinsics.shape[0]
    d = torch.stack([x.expand(B, height, width), y.expand(B, height, width),
                     torch.ones(B, height, width, device=dev)], -1)
    return d.reshape(B, height * width, 3)


def _ray_box(o, d, box_center, box_R, half_extents):
    """Slab test of rays d (B,HW,3) from o (B,3) against one OBB per env.
    Returns t (B,HW) and valid (B,HW)."""
    he = torch.tensor(half_extents, dtype=d.dtype, device=d.device)
    ol = torch.einsum("bji,bj->bi", box_R, o - box_center)
    dl = torch.einsum("bji,bri->brj", box_R, d)
    dl_safe = torch.where(torch.abs(dl) < 1e-9, torch.full_like(dl, 1e-9), dl)
    t1 = (-he - ol[:, None, :]) / dl_safe
    t2 = (he - ol[:, None, :]) / dl_safe
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    valid = (tmin < tmax) & (tmax > 0)
    return torch.where(tmin > 0, tmin, tmax), valid


def gripper_boxes(q):
    """Box centers (B,3,3) [left pad, right pad, base housing] and their
    shared rotation (B,3,3)."""
    base, Rg, pads, _ = physics.pad_frames(q)
    base_box = base.clone()
    base_box[:, 2] = base_box[:, 2] - BASE_CENTER_DEPTH
    return torch.stack([pads[:, 0], pads[:, 1], base_box], 1), Rg


def render(state: SimState, params: SimParams, cam_pos, cam_R, intrinsics,
           height, width, near=0.02, far=2.0):
    """Render a batch of envs. Returns depth (B,H,W) metric and seg (B,H,W)
    int32 ids. cam_pos (B,3), cam_R (B,3,3) camera-to-world (OpenCV axes),
    intrinsics (B,4)."""
    B = cam_pos.shape[0]
    HW = height * width
    d_cam = camera_rays(height, width, intrinsics)
    d = torch.einsum("bij,brj->bri", cam_R, d_cam)
    o = cam_pos
    K = state.objects.pos.shape[1]
    dev = d.device
    gripper_id = (K + 3) if params.has_tray else (K + 1)
    obj_id0 = 3 if params.has_tray else 1
    inf = torch.tensor(float("inf"), device=dev)
    ts, ids = [], []

    # support surface
    dz = d[..., 2]
    t_p = (params.support_z - o[:, None, 2]) / torch.where(
        torch.abs(dz) < 1e-9, torch.full_like(dz, 1e-9), dz)
    hit = o[:, None, :] + t_p[..., None] * d
    if params.has_tray:
        in_tray = (torch.abs(hit[..., 0]) < params.tray_half) & (
            torch.abs(hit[..., 1]) < params.tray_half)
        plane_ids = torch.where(in_tray, 2, 1).to(torch.int32)
    else:
        plane_ids = torch.zeros((B, HW), dtype=torch.int32, device=dev)
    ts.append(torch.where(t_p > 0, t_p, inf)[..., None])
    ids.append(plane_ids[..., None])

    # objects (sphere compounds)
    centers, radii, smask = physics.world_spheres(state, params)
    S = radii.shape[2]
    flat_c = centers.reshape(B, K * S, 3)
    flat_r = torch.where(smask, radii, torch.zeros_like(radii)).reshape(B, K * S)
    oc = o[:, None, :] - flat_c
    a = (d * d).sum(-1)
    b = 2.0 * torch.einsum("bri,bpi->brp", d, oc)
    c = (oc * oc).sum(-1)[:, None, :] - (flat_r ** 2)[:, None, :]
    disc = b * b - 4.0 * a[..., None] * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_s = (-b - sq) / (2.0 * a[..., None])
    v_s = (disc > 0) & (t_s > 0) & (flat_r > 0)[:, None, :]
    ts.append(torch.where(v_s, t_s, inf))
    slot = obj_id0 + torch.arange(K, device=dev, dtype=torch.int32).repeat_interleave(S)
    ids.append(slot.expand(B, HW, K * S))

    # gripper boxes
    box_c, Rg = gripper_boxes(state.gripper.q)
    for bi, he in enumerate((PAD_HALF_EXTENTS, PAD_HALF_EXTENTS, BASE_HALF_EXTENTS)):
        t_b, v_b = _ray_box(o, d, box_c[:, bi], Rg, he)
        ts.append(torch.where(v_b, t_b, inf)[..., None])
        ids.append(torch.full((B, HW, 1), gripper_id, dtype=torch.int32, device=dev))

    # tray walls
    if params.has_tray:
        eye = torch.eye(3, device=dev).expand(B, 3, 3)
        wall_c, wall_he, _, _ = physics.tray_walls(params)
        for bc, he in zip(wall_c, wall_he):
            bc_t = torch.tensor(bc, dtype=torch.float32, device=dev).expand(B, 3)
            t_w, v_w = _ray_box(o, d, bc_t, eye, he)
            ts.append(torch.where(v_w, t_w, inf)[..., None])
            ids.append(torch.full((B, HW, 1), 2, dtype=torch.int32, device=dev))

    t_all = torch.cat(ts, -1)
    id_all = torch.cat(ids, -1)
    t_clipped = torch.where(t_all < near, inf, t_all)
    best = torch.argmin(t_clipped, -1, keepdim=True)
    t_best = torch.gather(t_clipped, -1, best)[..., 0]
    depth = torch.clamp(t_best, max=far)
    no_hit = ~torch.isfinite(t_best)
    seg = torch.where(no_hit, -1, torch.gather(id_all, -1, best)[..., 0]).to(torch.int32)
    return depth.reshape(B, height, width), seg.reshape(B, height, width)


def camera_pose_from_gripper(gripper_q, t_rc, R_rc):
    """Wrist camera pose from the gripper pose and extrinsics (sensor.py:82-88):
    world rotation Rz(yaw) . Rx(pi), the hand pointing down."""
    Rz = physics.yaw_rotation(gripper_q[:, 3])
    Rx_pi = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
                         dtype=torch.float32, device=gripper_q.device)
    R_wr = torch.einsum("bij,jk->bik", Rz, Rx_pi)
    cam_pos = gripper_q[:, :3] + torch.einsum("bij,bj->bi", R_wr, t_rc)
    cam_R = torch.einsum("bij,bjk->bik", R_wr, R_rc)
    return cam_pos, cam_R


def object_visible(mask, params: SimParams, num_slots):
    """FOV check (robot.py:19-30): at least one object pixel per env."""
    obj_id0 = 3 if params.has_tray else 1
    m = mask.reshape(mask.shape[0], -1)
    return ((m >= obj_id0) & (m < obj_id0 + num_slots)).any(-1)
