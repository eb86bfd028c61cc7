"""Depth + segmentation (+ shade) ray-caster: CUDA kernel wrapper and its
plain version.

Replaces deep_rl_grasping_tpu/ops/raster_pallas.py (the Pallas TPU kernel
`_raster_kernel` :39, driven by `raster_depth_seg` :215 /
`render_batch_pallas` :307), with its `with_shade` output
(raster_pallas.py:204-205). The kernel is `csrc/raster.cu` (one thread per
pixel, a block row per env); its plain PyTorch version is
`render.raycast.render_shade`. On the H100 it is bound by float32
operations (~25 per pixel-sphere pair), not by bytes.

`render_batch` takes the plain version only for a state whose tensors lie on
the CPU. For CUDA tensors it launches the kernel or raises. RGB is
assembled outside the kernel from its shade and seg through the id -> color
table, as the JAX package does (raster_pallas.py:346-366).
"""

from __future__ import annotations

import numpy as np
import torch

from deep_rl_grasping_tpu_torch.ops import build
from deep_rl_grasping_tpu_torch.render import raycast
from deep_rl_grasping_tpu_torch.sim import physics
from deep_rl_grasping_tpu_torch.sim.types import SimParams, SimState


def raster_depth_seg(sph_centers, sph_radii, sph_ids, box_centers, box_R,
                     cam_origin, cam_R, intrinsics, *, H, W, has_tray, plane_z,
                     near, far, tray_half, wall_height, gripper_id, with_shade=False):
    """Launch the raster kernel on CUDA tensors (the inputs of
    raster_pallas.raster_depth_seg). Returns depth (B,H,W) f32, seg (B,H,W)
    i32 and, with `with_shade`, the shade (B,H,W) f32. Launches with shade
    count in `raster_depth_seg.shade_launches`, the others in `.launches`."""
    dev = sph_centers.device
    if dev.type != "cuda":
        raise ValueError("raster_depth_seg launches the CUDA kernel; pass CUDA tensors")
    B, P, _ = sph_centers.shape
    for name, t, shape in (("sph_centers", sph_centers, (B, P, 3)),
                           ("sph_radii", sph_radii, (B, P)),
                           ("box_centers", box_centers, (B, 3, 3)),
                           ("box_R", box_R, (B, 3, 3)),
                           ("cam_origin", cam_origin, (B, 3)),
                           ("cam_R", cam_R, (B, 3, 3)),
                           ("intrinsics", intrinsics, (B, 4))):
        build.check_tensor(t, name, shape, dev)
    if sph_ids.dtype != torch.int32 or tuple(sph_ids.shape) != (B, P) \
            or sph_ids.device != dev or not sph_ids.is_contiguous():
        raise ValueError("sph_ids must be a contiguous (B, P) int32 CUDA tensor")
    lib = build.library()
    depth = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    seg = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    shade = torch.empty((B, H, W), dtype=torch.float32, device=dev) if with_shade else None
    fp = np.asarray([plane_z, near, far, tray_half, wall_height], np.float32)
    ip = np.asarray([B, P, H, W, int(bool(has_tray)), int(gripper_id)], np.int32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.raster_run(
            fp.ctypes.data, ip.ctypes.data, sph_centers.data_ptr(), sph_radii.data_ptr(),
            sph_ids.data_ptr(), box_centers.data_ptr(), box_R.data_ptr(),
            cam_origin.data_ptr(), cam_R.data_ptr(), intrinsics.data_ptr(),
            depth.data_ptr(), seg.data_ptr(), None if shade is None else shade.data_ptr(),
            stream)
    build.check(err, "raster_kernel")
    if with_shade:
        raster_depth_seg.shade_launches += 1
        return depth, seg, shade
    raster_depth_seg.launches += 1
    return depth, seg


raster_depth_seg.launches = 0
raster_depth_seg.shade_launches = 0


def kernel_inputs(states: SimState, params: SimParams, cam_pos, cam_R, intrinsics,
                  H=64, W=64, near=0.02, far=2.0):
    """Positional and keyword arguments of `raster_depth_seg`: world-space
    spheres, gripper boxes and camera per env (what the Pallas adapter
    render_batch_pallas gathers)."""
    dev = cam_pos.device
    B, K = states.objects.pos.shape[:2]
    centers, radii, mask = physics.world_spheres(states, params)
    S = radii.shape[-1]
    obj_id0 = 3 if params.has_tray else 1
    ids = (obj_id0 + torch.arange(K, device=dev, dtype=torch.int32).repeat_interleave(S))
    box_c, box_R = raycast.gripper_boxes(states.gripper.q)
    c = lambda x: x.to(torch.float32).contiguous()
    args = (c(centers.reshape(B, K * S, 3)),
            c(torch.where(mask, radii, torch.zeros_like(radii)).reshape(B, K * S)),
            ids.expand(B, K * S).contiguous(), c(box_c), c(box_R), c(cam_pos), c(cam_R),
            c(intrinsics))
    kw = dict(H=H, W=W, has_tray=params.has_tray, plane_z=float(params.support_z),
              near=near, far=far, tray_half=float(params.tray_half),
              wall_height=float(params.tray_wall_height),
              gripper_id=(K + 3) if params.has_tray else (K + 1))
    return args, kw


def render_batch(states: SimState, params: SimParams, cam_pos, cam_R, intrinsics,
                 H=64, W=64, near=0.02, far=2.0, with_rgb=False):
    """Batched render: (depth, seg), or (rgb, depth, seg) with `with_rgb`.
    The plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    dev = cam_pos.device
    if dev.type == "cpu":
        return raycast.render(states, params, cam_pos, cam_R, intrinsics, H, W, near, far,
                              with_rgb=with_rgb)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    args, kw = kernel_inputs(states, params, cam_pos, cam_R, intrinsics, H, W, near, far)
    out = raster_depth_seg(*args, **kw, with_shade=with_rgb)
    if not with_rgb:
        return out
    depth, seg, shade = out
    rgb = raycast.shade_to_rgb(seg, shade, raycast.color_lut(params, states.objects.obj_type))
    return rgb, depth, seg
