"""Depth + segmentation (+ shade) ray-caster: CUDA kernel wrapper and its
plain version.

Replaces deep_rl_grasping_tpu/ops/raster_pallas.py (the Pallas TPU kernel
`_raster_kernel` :39, driven by `raster_depth_seg` :215 /
`render_batch_pallas` :307), with its `with_shade` output
(raster_pallas.py:204-205). The kernel is `csrc/raster.cu`: one block per
(env, screen tile), one thread per pixel; the block stages the env's
camera, gripper-box frame and spheres in shared memory once and keeps
only the spheres its tile's rays can hit (`tile_sphere_mask` is the plain
twin of that cull). Its plain PyTorch version is `render.raycast.render_shade`.
On the H100 it is bound by per-block latency, not by bytes or operations
(see the note at the top of csrc/raster.cu). `launch_config` gives the
tile grid and the shared-memory size that the C entry checks and launches
with.

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

# Screen tile of one block (csrc/raster.cu TILE_W, TILE_H), chosen by
# measurement on an H100 (PERF.md).
TILE = (16, 8)
# Shared-memory layout of csrc/raster.cu `raster_shared_bytes`: per sphere a
# float4 (o - c, |o - c|^2 - r^2), its radius and its id; then the env's
# constants (camera origin 3, cam_R 9, intrinsics 4, gripper rotation 9,
# box-frame origins 9) and the list's length.
SPHERE_BYTES = 24
CONST_FLOATS = 34
# Cull margin (csrc/raster.cu, where it is sized): a sphere of radius r
# whose centre lies L from the camera is kept while it lies within
# r + CULL_LINEAR * L + CULL_QUADRATIC * L^2 / r of every side plane.
CULL_LINEAR = 1e-4
CULL_QUADRATIC = 1e-5
# check_lists holds the kernel's lists to the twin's with the margin moved
# by +-TWIN_SLACK * L: the two compute the cull in float32 with other
# contractions, and their side-plane distances differ by a few roundings of
# terms bounded by L, amplified by 1 / sin of the corner rays' angle
# (> 0.08 rad), so by a few 1e-6 L at most; the slack is ~10x that and half
# of CULL_LINEAR.
TWIN_SLACK = 5e-5


def launch_config(B: int, P: int, H: int, W: int) -> dict:
    """Launch shape of the raster kernel: a (tiles, B) grid of blocks of
    TILE threads, one per pixel of a screen tile, with the env's constants
    and the tile's sphere list in dynamic shared memory sized by P."""
    if not 1 <= B <= 65535:
        raise ValueError(f"B={B}: the grid's env axis holds 1..65535 envs")
    if P < 0 or H < 1 or W < 1:
        raise ValueError(f"P={P}, H={H}, W={W}: no such launch")
    tw, th = TILE
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    return {"tile": TILE, "tiles": tiles_x * tiles_y, "grid": (tiles_x * tiles_y, int(B)),
            "threads": tw * th, "shared_bytes": SPHERE_BYTES * P + 4 * (CONST_FLOATS + 1)}


def _check_inputs(sph_centers, sph_radii, sph_ids, box_centers, box_R, cam_origin, cam_R,
                  intrinsics):
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
    return dev, B, P


def launch(ins, *, H, W, has_tray, plane_z, near, far, tray_half, wall_height,
           gripper_id, with_shade=False, cull=True, lists=False, lib=None):
    """One launch of the raster kernel on `ins` (the positional arguments of
    raster_depth_seg), checked first; counts nothing. With `lists` (for the
    checks), the kernel also writes each tile's sphere list, returned last
    as a (B, tiles, P) bool mask like tile_sphere_mask's. `lib` defaults to
    this tree's build; it may be another tree's build of csrc/raster.cu
    (tools/raster_probe.py): raster_run's C signature is the same, and an
    older kernel reads only ip[0:6]."""
    dev, B, P = _check_inputs(*ins)
    lib = lib or build.library()
    cfg = launch_config(B, P, H, W)
    depth = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    seg = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    shade = torch.empty((B, H, W), dtype=torch.float32, device=dev) if with_shade else None
    fp = np.asarray([plane_z, near, far, tray_half, wall_height], np.float32)
    ip = np.asarray([B, P, H, W, int(bool(has_tray)), int(gripper_id), int(bool(cull)),
                     cfg["shared_bytes"]], np.int32)
    ptrs = [fp.ctypes.data, ip.ctypes.data, *[t.data_ptr() for t in ins], depth.data_ptr(),
            seg.data_ptr(), None if shade is None else shade.data_ptr()]
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = torch.empty((B, cfg["tiles"], -(-P // 32)), dtype=torch.int32, device=dev) \
        if lists else None
    with torch.cuda.device(dev):
        if lists:
            err = lib.raster_run_lists(*ptrs, words.data_ptr(), stream)
        else:
            err = lib.raster_run(*ptrs, stream)
    build.check(err, "raster_kernel")
    out = (depth, seg, shade) if with_shade else (depth, seg)
    return out + (unpack_lists(words, P),) if lists else out


def unpack_lists(words, P):
    """(B, tiles, ceil(P / 32)) int32 words, bit i of word w for sphere
    32 w + i (csrc/raster.cu raster_run_lists), as a (B, tiles, P) bool
    mask."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1  # an arithmetic shift keeps bit 31 too
    return bits.reshape(*words.shape[:-1], -1)[..., :P].bool()


def raster_depth_seg(sph_centers, sph_radii, sph_ids, box_centers, box_R,
                     cam_origin, cam_R, intrinsics, *, H, W, has_tray, plane_z,
                     near, far, tray_half, wall_height, gripper_id, with_shade=False,
                     cull=True):
    """Launch the raster kernel on CUDA tensors (the inputs of
    raster_pallas.raster_depth_seg). Returns depth (B,H,W) f32, seg (B,H,W)
    i32 and, with `with_shade`, the shade (B,H,W) f32. `cull=False` puts
    every live sphere in every tile's list (for the culling check only;
    the outputs must be bit-equal). Launches with shade count in
    `raster_depth_seg.shade_launches`, the others in `.launches`."""
    out = launch((sph_centers, sph_radii, sph_ids, box_centers, box_R, cam_origin, cam_R,
                  intrinsics), H=H, W=W, has_tray=has_tray, plane_z=plane_z, near=near, far=far,
                 tray_half=tray_half, wall_height=wall_height, gripper_id=gripper_id,
                 with_shade=with_shade, cull=cull)
    if with_shade:
        raster_depth_seg.shade_launches += 1
    else:
        raster_depth_seg.launches += 1
    return out


raster_depth_seg.launches = 0
raster_depth_seg.shade_launches = 0


def _tile_edges(H, W, dev=None):
    """Per screen tile (row-major, as the kernel's blockIdx.x), its pixel
    edges x0, x1, y0, y1, clipped to the image."""
    tw, th = TILE
    tiles_x, tiles_y = -(-W // tw), -(-H // th)
    tx = torch.arange(tiles_x, device=dev).repeat(tiles_y)
    ty = torch.arange(tiles_y, device=dev).repeat_interleave(tiles_x)
    return tx * tw, torch.clamp((tx + 1) * tw, max=W), ty * th, torch.clamp((ty + 1) * th, max=H)


def _tile_corner_rays(cam_R, intrinsics, H, W):
    """Per env and screen tile, the rays through the tile's four outer
    corners, (B, tiles, 4, 3), in the order (x0,y0), (x1,y0), (x1,y1),
    (x0,y1): the pixel edges, clipped to the image, so every pixel centre's
    ray lies inside the cone they span (csrc/raster.cu `tile_cone`)."""
    x0, x1, y0, y1 = (e.float() for e in _tile_edges(H, W, cam_R.device))
    xs = torch.stack([x0, x1, x1, x0], -1)  # (tiles, 4)
    ys = torch.stack([y0, y0, y1, y1], -1)
    fx, fy, cx, cy = (intrinsics[:, i, None, None] for i in range(4))
    u = (xs[None] - cx) / fx
    v = (ys[None] - cy) / fy
    R = cam_R[:, None, None]
    return (R[..., 0] * u[..., None] + R[..., 1] * v[..., None] + R[..., 2])


def tile_sphere_mask(sph_centers, sph_radii, cam_origin, cam_R, intrinsics, H, W, slack=0.0):
    """Plain twin of the kernel's per-tile cull: (B, tiles, P) booleans,
    True where sphere p is in tile t's list. A live sphere (r > 0) is kept
    unless its centre lies more than r' outside one of the four side
    planes of the tile's cone of rays, or more than r' behind the camera
    along the sum of the corner rays (tested only where that sum points
    into the cone), with r' = r + (CULL_LINEAR + slack) * L
    + CULL_QUADRATIC * L^2 / r and L the centre's distance from the camera
    (the kernel's margin at slack 0; check_lists moves it). Every
    comparison keeps the sphere when it is not a number."""
    d = _tile_corner_rays(cam_R, intrinsics, H, W)  # (B, T, 4, 3)
    f = d.sum(2)  # (B, T, 3)
    n = torch.linalg.cross(d, torch.roll(d, -1, dims=2), dim=-1)
    n = torch.where(((n * f[:, :, None]).sum(-1) < 0)[..., None], -n, n)
    oc = sph_centers - cam_origin[:, None]  # (B, P, 3): centre from the camera
    L2 = (oc * oc).sum(-1)
    r = sph_radii
    live = r > 0
    rr = (r + (CULL_LINEAR + slack) * torch.sqrt(L2)
          + CULL_QUADRATIC * L2 / torch.where(live, r, 1.0))
    side = torch.einsum("btkj,bpj->btpk", n, oc)  # (B, T, P, 4)
    n_len = torch.linalg.vector_norm(n, dim=-1)[:, :, None, :]
    out_side = (side < -rr[:, None, :, None] * n_len).any(-1)
    forward = ((d * f[:, :, None]).sum(-1) > 0).all(-1)  # (B, T)
    behind = (torch.einsum("btj,bpj->btp", f, oc)
              < -rr[:, None, :] * torch.linalg.vector_norm(f, dim=-1)[..., None])
    behind = behind & forward[..., None]
    return live[:, None, :] & ~out_side & ~behind


def check_lists(lists, sph_centers, sph_radii, cam_origin, cam_R, intrinsics, H, W):
    """The kernel's tile lists (launch(lists=True)) against the twin's:
    `listed_beyond_twin` counts the (env, tile, sphere) the kernel lists
    though the twin drops them with its margin grown by TWIN_SLACK * L,
    `twin_not_listed` those the twin keeps with its margin shrunk by as
    much that the kernel does not list. Both are 0 when the kernel culls as
    its twin does, up to rounding."""
    twin = lambda s: tile_sphere_mask(sph_centers, sph_radii, cam_origin, cam_R, intrinsics, H,
                                      W, slack=s)
    return {"listed_beyond_twin": int((lists & ~twin(TWIN_SLACK)).sum()),
            "twin_not_listed": int((twin(-TWIN_SLACK) & ~lists).sum())}


def pairs_tested(mask, H, W):
    """The share of pixel-sphere pairs (B * H * W * P) that a culled launch
    tests, from a (B, tiles, P) list mask: the kernel's (launch(lists=True))
    or the twin's."""
    x0, x1, y0, y1 = _tile_edges(H, W, mask.device)
    px = ((x1 - x0) * (y1 - y0)).double()
    B, _, P = mask.shape
    return float((mask.sum(-1).double() * px).sum() / (B * H * W * P))


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
