"""Batched ray-cast RGB / depth / segmentation renderer (plain PyTorch).

Port of deep_rl_grasping_tpu/render/raycast.py (`render` :101,
`camera_pose_from_gripper` :240, `object_visible` :258) with the env axis
written out. This is the plain version of the raster kernel
(ops/raster_cuda.py, csrc/raster.cu). With `with_rgb=True` it also returns
the RGB image: the winning primitive's headlight Lambert shade
(0.35 + 0.65 * clip(-n.d/|d|, 0, 1), 0 where nothing is hit) times its
color, looked up by segmentation id (raycast.py:133-138, :219-232).

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

GRIPPER_COLOR = (0.35, 0.35, 0.38)
SURFACE_COLOR = (0.55, 0.5, 0.45)
TRAY_COLOR = (0.35, 0.45, 0.35)


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
    Returns t (B,HW), valid (B,HW) and the world normal of the entry face
    (B,HW,3): the axis of the largest slab entry, facing the ray.

    Origin and direction both go into the box frame by R^T, as the Pallas
    kernel does (raster_pallas.py:140-145). The JAX package's XLA renderer
    rotates the direction by R instead (raycast.py:80), which moves the
    finger pads in the wrist image whenever the gripper yaw is not zero."""
    he = torch.tensor(half_extents, dtype=d.dtype, device=d.device)
    ol = torch.einsum("bji,bj->bi", box_R, o - box_center)
    dl = torch.einsum("bji,brj->bri", box_R, d)
    dl_safe = torch.where(torch.abs(dl) < 1e-9, torch.full_like(dl, 1e-9), dl)
    t1 = (-he - ol[:, None, :]) / dl_safe
    t2 = (he - ol[:, None, :]) / dl_safe
    tlo = torch.minimum(t1, t2)
    tmin = tlo.amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    valid = (tmin < tmax) & (tmax > 0)
    ax = torch.argmax(tlo, -1, keepdim=True)
    sign = -torch.sign(torch.gather(dl, -1, ax))
    n_local = torch.zeros_like(dl).scatter_(-1, ax, sign)
    n_world = torch.einsum("bij,brj->bri", box_R, n_local)
    return torch.where(tmin > 0, tmin, tmax), valid, n_world


def gripper_boxes(q):
    """Box centers (B,3,3) [left pad, right pad, base housing] and their
    shared rotation (B,3,3)."""
    base, Rg, pads, _ = physics.pad_frames(q)
    base_box = base.clone()
    base_box[:, 2] = base_box[:, 2] - BASE_CENTER_DEPTH
    return torch.stack([pads[:, 0], pads[:, 1], base_box], 1), Rg


def color_lut(params: SimParams, obj_type):
    """Per-env id -> RGB table (B, n_ids, 3) for the segmentation layout of
    the module docstring (raycast.py:220-232; index 0 of the table layout
    is unused)."""
    B = obj_type.shape[0]
    dev = obj_type.device
    c = lambda rgb: torch.tensor(rgb, dtype=torch.float32, device=dev).expand(B, 1, 3)
    obj_cols = params.color[obj_type]
    if params.has_tray:
        parts = [c(SURFACE_COLOR), c(SURFACE_COLOR), c(TRAY_COLOR), obj_cols, c(GRIPPER_COLOR)]
    else:
        parts = [c(SURFACE_COLOR), obj_cols, c(GRIPPER_COLOR)]
    return torch.cat(parts, 1)


def shade_to_rgb(seg, shade, lut):
    """RGB (B,H,W,3) from seg ids and shade (B,H,W) through the id -> color
    table; a miss (id -1) is black (render_batch_pallas, raster_pallas.py:346-366)."""
    B, H, W = seg.shape
    shade = torch.where(seg < 0, torch.zeros_like(shade), shade)
    idx = torch.clamp(seg, min=0).reshape(B, H * W, 1).long().expand(B, H * W, 3)
    return torch.gather(lut, 1, idx).reshape(B, H, W, 3) * shade[..., None]


def render(state: SimState, params: SimParams, cam_pos, cam_R, intrinsics,
           height, width, near=0.02, far=2.0, with_rgb=False):
    """Render a batch of envs. Returns depth (B,H,W) metric and seg (B,H,W)
    int32 ids; with_rgb=True returns (rgb (B,H,W,3) in [0,1], depth, seg).
    cam_pos (B,3), cam_R (B,3,3) camera-to-world (OpenCV axes),
    intrinsics (B,4)."""
    depth, seg, shade = render_shade(state, params, cam_pos, cam_R, intrinsics, height,
                                     width, near, far, with_shade=with_rgb)
    if not with_rgb:
        return depth, seg
    return shade_to_rgb(seg, shade, color_lut(params, state.objects.obj_type)), depth, seg


def render_shade(state: SimState, params: SimParams, cam_pos, cam_R, intrinsics,
                 height, width, near=0.02, far=2.0, with_shade=True):
    """Depth, seg and, with `with_shade`, the winner's headlight shade
    (B,H,W), 0 on a miss (else None): the outputs of the raster kernel."""
    B = cam_pos.shape[0]
    t_clipped, id_all, shade_all = hit_candidates(state, params, cam_pos, cam_R, intrinsics,
                                                  height, width, near, with_shade)
    best = torch.argmin(t_clipped, -1, keepdim=True)
    t_best = torch.gather(t_clipped, -1, best)[..., 0]
    depth = torch.clamp(t_best, max=far).reshape(B, height, width)
    no_hit = ~torch.isfinite(t_best)
    seg = torch.where(no_hit, -1, torch.gather(id_all, -1, best)[..., 0]).to(torch.int32)
    seg = seg.reshape(B, height, width)
    if not with_shade:
        return depth, seg, None
    shade = torch.gather(shade_all, -1, best)[..., 0]
    shade = torch.where(no_hit, torch.zeros_like(shade), shade).reshape(B, height, width)
    return depth, seg, shade


def hit_candidates(state: SimState, params: SimParams, cam_pos, cam_R, intrinsics,
                   height, width, near=0.02, with_shade=True):
    """Every primitive's hit on every ray, in the kernel's test order (the
    plane, the P spheres, the three gripper boxes, the tray walls): t
    (B,HW,C), inf on a miss or before `near`; ids (B,HW,C); and, with
    `with_shade`, each hit's headlight shade (B,HW,C) (else None)."""
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
    ts, ids, shades = [], [], []
    d_norm = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-9)

    def headlight(n_world):
        ndotl = -(n_world * d).sum(-1) / d_norm
        return (0.35 + 0.65 * torch.clamp(ndotl, 0.0, 1.0))[..., None]

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
    if with_shade:
        up = torch.tensor([0.0, 0.0, 1.0], device=dev)
        shades.append(headlight(up.expand(B, HW, 3)))

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
    if with_shade:
        hit_s = o[:, None, None, :] + t_s[..., None] * d[:, :, None, :]
        n_s = (hit_s - flat_c[:, None]) / torch.clamp(flat_r, min=1e-9)[:, None, :, None]
        nd = -(n_s * d[:, :, None, :]).sum(-1) / d_norm[..., None]
        shades.append(0.35 + 0.65 * torch.clamp(nd, 0.0, 1.0))

    # gripper boxes
    box_c, Rg = gripper_boxes(state.gripper.q)
    for bi, he in enumerate((PAD_HALF_EXTENTS, PAD_HALF_EXTENTS, BASE_HALF_EXTENTS)):
        t_b, v_b, n_b = _ray_box(o, d, box_c[:, bi], Rg, he)
        ts.append(torch.where(v_b, t_b, inf)[..., None])
        ids.append(torch.full((B, HW, 1), gripper_id, dtype=torch.int32, device=dev))
        if with_shade:
            shades.append(headlight(n_b))

    # tray walls
    if params.has_tray:
        eye = torch.eye(3, device=dev).expand(B, 3, 3)
        wall_c, wall_he, _, _ = physics.tray_walls(params)
        for bc, he in zip(wall_c, wall_he):
            bc_t = torch.tensor(bc, dtype=torch.float32, device=dev).expand(B, 3)
            t_w, v_w, n_w = _ray_box(o, d, bc_t, eye, he)
            ts.append(torch.where(v_w, t_w, inf)[..., None])
            ids.append(torch.full((B, HW, 1), 2, dtype=torch.int32, device=dev))
            if with_shade:
                shades.append(headlight(n_w))

    t_all = torch.cat(ts, -1)
    return (torch.where(t_all < near, inf, t_all), torch.cat(ids, -1),
            torch.cat(shades, -1) if with_shade else None)


def shade_gap(seg, shade, candidates, tie_tol):
    """Per pixel (B,H,W), the distance from `shade` to the nearest shade
    this plain version admits there: that of any hit with id `seg` whose t
    lies within `tie_tol` of the nearest hit (`candidates` is
    hit_candidates' output), and 0 on a miss. Where two overlapping spheres
    of one object meet, the normal jumps across the crease and which of them
    is nearer is decided by float rounding, so either shade is right there;
    elsewhere the gap is |shade - this version's shade|."""
    t, ids, sh = candidates
    B, H, W = seg.shape
    seg = seg.reshape(B, H * W, 1)
    shade = shade.reshape(B, H * W, 1)
    tie = (ids == seg) & (t <= t.amin(-1, keepdim=True) + tie_tol)
    gap = torch.where(tie, (sh - shade).abs(), torch.full_like(sh, float("inf"))).amin(-1)
    return torch.where(seg[..., 0] < 0, shade[..., 0].abs(), gap).reshape(B, H, W)


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
