"""The raster kernel's per-tile sphere cull, on the CPU.

csrc/raster.cu gives each screen tile a list of the spheres its rays can
hit; `raster_cuda.tile_sphere_mask` is the plain twin of that cull, in the
same float32 arithmetic. The kernel's culled and cull-off launches must be
bit-equal on the card (tests/test_torch_cuda.py, chip_smoke.py); here the
twin is held conservative against the plain renderer: every sphere with a
hit on any pixel of a tile (`raycast.hit_candidates`), so in particular
every pixel's winner and every sphere hit within DEPTH_TOL of the nearest,
is in that tile's list. On the port's own states (OnFloor, OnTable, the
grippers yawed and half of them lowered onto an object, the nominal and
the randomized cameras) and on crafted spheres: across a tile corner,
around the camera, behind it, at the near plane, and dead slots. Also:
`check_lists`, which holds the kernel's lists to the twin's on the card,
accepts the twin's own lists and catches lists that keep every sphere or
drop a kept one; the kernel's list words unpack to the right spheres;
`launch_config` fits the device's limits at the shapes the paths use,
and the kernel source states the same tile, layout and margins as the
wrapper. No JAX here; B <= 8.
"""

import os
import re

import pytest
import torch

from deep_rl_grasping_tpu_torch.envs.grasp_env import GraspEnv
from deep_rl_grasping_tpu_torch.ops import raster_cuda
from deep_rl_grasping_tpu_torch.render import raycast
from deep_rl_grasping_tpu_torch.utils import config as cfg_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "trained", "sac_full_flagship_r5c", "config.yaml")
TRAIN_CONFIG = os.path.join(REPO, "configs", "sac_rgbd_flagship.yaml")
SOURCE = os.path.join(REPO, "deep_rl_grasping_tpu_torch", "csrc", "raster.cu")
H = W = 64
NEAR = 0.02
DEPTH_TOL = 1e-4  # chip_smoke.DEPTH_TOL: ties within rounding
INTR = [69.76, 77.25, 32.19, 32.0]


def _tile_of_pixel():
    """(H*W,) index of each pixel's tile, row-major pixels and tiles."""
    tw, th = raster_cuda.TILE
    tiles_x = -(-W // tw)
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    return ((ys // th) * tiles_x + xs // tw).reshape(-1)


def _sphere_hits(centers, radii, cam_origin, cam_R, intrinsics):
    """(B, H*W, P) t of each sphere's hit on each pixel ray (inf on a miss
    or before NEAR), in the plain version's arithmetic."""
    d = torch.einsum("bij,brj->bri", cam_R, raycast.camera_rays(H, W, intrinsics))
    oc = cam_origin[:, None, :] - centers
    a = (d * d).sum(-1)
    b = 2.0 * torch.einsum("bri,bpi->brp", d, oc)
    c = (oc * oc).sum(-1)[:, None, :] - (radii ** 2)[:, None, :]
    disc = b * b - 4.0 * a[..., None] * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a[..., None])
    hit = (disc > 0) & (t > 0) & (radii > 0)[:, None, :] & (t >= NEAR)
    return torch.where(hit, t, torch.full_like(t, float("inf")))


def _assert_conservative(ins, near_winner=None):
    """Every sphere hit from a pixel is in that pixel's tile list. Returns
    the mask."""
    centers, radii, cam_o, cam_R, intr = ins[0], ins[1], ins[5], ins[6], ins[7]
    mask = raster_cuda.tile_sphere_mask(centers, radii, cam_o, cam_R, intr, H, W)
    listed = mask[:, _tile_of_pixel()]  # (B, H*W, P)
    hits = torch.isfinite(_sphere_hits(centers, radii, cam_o, cam_R, intr))
    missing = hits & ~listed
    assert not bool(missing.any()), torch.nonzero(missing)[:5].tolist()
    if near_winner is not None:
        assert not bool((near_winner & ~listed).any())
    return mask


def _env(kind):
    if kind == "train":
        env = GraspEnv(cfg_util.load_config(TRAIN_CONFIG), device="cpu")
        assert env.randomize is not None
        return env
    cfg = cfg_util.load_config(FLAGSHIP)
    cfg["scene"]["scene_type"] = kind
    return GraspEnv(cfg, evaluate=True, validate=True, device="cpu")


def _scene_args(env, B=8, seed=0):
    """render_batch's arguments for B scenes of env: grippers yawed over the
    circle, the second half lowered onto object slot 0 (objects large in
    the wrist view, some spheres near the camera)."""
    gen = torch.Generator().manual_seed(seed)
    es = env.reset_env(gen, B, 1.0)
    st = es.sim
    q = st.gripper.q.clone()
    half = torch.arange(B) >= B // 2
    q[half, 0:2] = st.objects.pos[half, 0, 0:2]
    q[half, 2] = env.sim_params.support_z + 0.266
    q[:, 3] = torch.linspace(-3.0, 3.0, B)
    st = st.replace(gripper=st.gripper.replace(q=q))
    cam_pos, cam_R = raycast.camera_pose_from_gripper(q, es.cam_t, es.cam_R)
    return (st, env.sim_params, cam_pos, cam_R, es.intrinsics, H, W, NEAR, env.far)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["OnFloor", "OnTable", "train"])
def test_tile_sphere_mask_keeps_every_sphere_a_tile_hits(kind, seed):
    env = _env(kind)
    args = _scene_args(env, seed=seed)
    ins, _ = raster_cuda.kernel_inputs(*args)
    # each pixel's winner, and every candidate within DEPTH_TOL of the
    # nearest hit, among the sphere candidates (after the plane, before the
    # boxes in hit_candidates' order)
    t, _, _ = raycast.hit_candidates(*args[:7], NEAR, with_shade=False)
    P = ins[0].shape[1]
    near_winner = (t <= t.amin(-1, keepdim=True) + DEPTH_TOL) & torch.isfinite(t)
    near_winner = near_winner[..., 1:1 + P]
    assert bool(near_winner.any())  # some pixel sees a sphere first
    mask = _assert_conservative(ins, near_winner)
    if kind == "train":
        assert float((args[4] - args[4][:1]).abs().max()) > 0  # per-env intrinsics
    # the cull does drop most pairs in a wrist view
    assert raster_cuda.pairs_tested(mask, H, W) < 0.5


def _lookdown(B=1, height=0.3):
    cam_o = torch.tensor([[0.0, 0.0, height]]).expand(B, 3).contiguous()
    cam_R = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])
    intr = torch.tensor([INTR]).expand(B, 4).contiguous()
    return cam_o, cam_R.expand(B, 3, 3).contiguous(), intr


def _ray_through(x, y, cam_o, cam_R, intr, dist):
    """Point at `dist` along the ray of pixel position (x, y)."""
    fx, fy, cx, cy = intr[0].tolist()
    d = cam_R[0] @ torch.tensor([(x - cx) / fx, (y - cy) / fy, 1.0])
    return cam_o[0] + dist * d / torch.linalg.vector_norm(d)


def _inputs(centers, radii, cam_o, cam_R, intr):
    P = len(radii)
    z3 = torch.zeros(1, 3, 3)
    return (torch.stack(centers)[None], torch.tensor([radii]), torch.zeros(1, P, dtype=torch.int32),
            z3, z3, cam_o, cam_R, intr)


def test_tile_sphere_mask_on_crafted_spheres():
    cam_o, cam_R, intr = _lookdown()
    tw, th = raster_cuda.TILE
    fwd = cam_R[0][:, 2]
    centers = [
        _ray_through(2 * tw, 2 * th, cam_o, cam_R, intr, 0.2),  # across a tile corner
        cam_o[0] + torch.tensor([0.003, -0.002, 0.001]),        # holding the camera origin
        cam_o[0] - 0.1 * fwd,                                   # behind the camera
        _ray_through(20.5, 40.5, cam_o, cam_R, intr, NEAR + 0.008),  # across the near plane
        _ray_through(40.0, 10.0, cam_o, cam_R, intr, 0.15),     # a dead slot
        _ray_through(W, 0.5 * H, cam_o, cam_R, intr, 0.25),     # across the image edge
        _ray_through(3 * tw, th, cam_o, cam_R, intr, 0.3),      # on a tile edge, between rays
    ]
    radii = [0.004, 0.01, 0.02, 0.01, 0.0, 0.01, 0.0003]
    ins = _inputs(centers, radii, cam_o, cam_R, intr)
    mask = _assert_conservative(ins)[0]  # (tiles, P)
    hits = torch.isfinite(_sphere_hits(ins[0], ins[1], cam_o, cam_R, intr))[0]
    tile = _tile_of_pixel()
    hit_tiles = lambda p: set(tile[hits[:, p]].tolist())
    assert len(hit_tiles(0)) == 4 and bool(mask[:, 0].sum() >= 4)
    assert not bool(hits[:, 1].any()) and bool(mask[:, 1].all())  # seen from inside: no hit
    assert not bool(mask[:, 2].any())                               # culled everywhere
    t_near = _sphere_hits(ins[0], ins[1], cam_o, cam_R, intr)[0, :, 3]
    assert bool(hits[:, 3].any()) and float(t_near.min()) < NEAR + 1e-3  # cut by the near plane
    assert not bool(mask[:, 4].any()) and not bool(hits[:, 4].any())
    assert len(hit_tiles(5)) >= 2
    assert not bool(hits[:, 6].any())


def test_tile_sphere_mask_culls_from_any_camera_rotation():
    """Randomly rotated cameras (any cam_R, also a reflection) and random
    spheres: the twin stays conservative and still culls."""
    g = torch.Generator().manual_seed(3)
    B, P = 8, 48
    q, _ = torch.linalg.qr(torch.randn(B, 3, 3, generator=g))
    q[0, :, 0] = -q[0, :, 0]  # det -1
    cam_o = torch.randn(B, 3, generator=g) * 0.1
    centers = cam_o[:, None] + torch.randn(B, P, 3, generator=g) * 0.3
    radii = torch.rand(B, P, generator=g) * 0.03
    radii[:, ::7] = 0.0
    intr = torch.tensor([INTR]) * (1 + 0.1 * torch.rand(B, 4, generator=g))
    ins = (centers, radii, None, None, None, cam_o, q.contiguous(), intr)
    mask = _assert_conservative(ins)
    assert raster_cuda.pairs_tested(mask, H, W) < 0.3


def test_pairs_tested_counts_pixels_per_tile():
    tiles = raster_cuda.launch_config(2, 5, H, W)["tiles"]
    assert raster_cuda.pairs_tested(torch.ones(2, tiles, 5, dtype=torch.bool), H, W) == 1.0
    assert raster_cuda.pairs_tested(torch.zeros(2, tiles, 5, dtype=torch.bool), H, W) == 0.0
    one = torch.zeros(2, tiles, 5, dtype=torch.bool)
    one[0, 0, 0] = True
    tw, th = raster_cuda.TILE
    assert raster_cuda.pairs_tested(one, H, W) == tw * th / (2 * H * W * 5)


@pytest.mark.parametrize("P", [40, 48])
@pytest.mark.parametrize("B", [1, 100, 128])
def test_launch_config_fits_the_device(P, B):
    """At the paths' shapes (P = K objects x 8 spheres: 40 at K=5, 48 at
    K=6): a block's threads and shared bytes fit an H100 without opting in
    (1024 threads, 48 KiB), the tiles cover the image and the env axis
    fits the grid."""
    c = raster_cuda.launch_config(B, P, H, W)
    tw, th = c["tile"]
    assert c["threads"] == tw * th and c["threads"] % 32 == 0 and c["threads"] <= 1024
    assert c["shared_bytes"] == 24 * P + 4 * 35 and c["shared_bytes"] <= 48 * 1024
    assert c["tiles"] * tw * th >= H * W and c["grid"] == (c["tiles"], B) and B <= 65535


def test_launch_config_refuses_what_the_kernel_cannot_launch():
    for shape in ((70000, 40, H, W), (0, 40, H, W), (4, -1, H, W), (4, 40, 0, W)):
        with pytest.raises(ValueError):
            raster_cuda.launch_config(*shape)


def _pack(mask):
    """(B, tiles, P) bools as the kernel's list words: bit i of word w for
    sphere 32 w + i, as int32."""
    B, T, P = mask.shape
    words = torch.zeros(B, T, -(-P // 32), dtype=torch.int64)
    for p in range(P):
        words[..., p // 32] |= mask[..., p].long() << (p % 32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


@pytest.mark.parametrize("P", [1, 31, 32, 33, 40, 48, 64])
def test_unpack_lists_reads_every_bit(P):
    """The kernel's list words unpack to the spheres whose bits are set,
    bit 31 (a negative int32 word) included."""
    g = torch.Generator().manual_seed(P)
    mask = torch.rand(3, 32, P, generator=g) < 0.5
    mask[0, 0] = True  # every bit of a word set
    assert torch.equal(raster_cuda.unpack_lists(_pack(mask), P), mask)


@pytest.mark.parametrize("kind", ["OnFloor", "OnTable", "train"])
def test_check_lists_catches_a_cull_unlike_the_twin(kind):
    """check_lists, which holds the kernel's tile lists to the twin's on
    the card, passes the twin's own lists and counts what a cull that keeps
    every live sphere, or drops one the twin keeps, lists differently."""
    args = _scene_args(_env(kind))
    ins, _ = raster_cuda.kernel_inputs(*args)
    cull = (ins[0], ins[1], ins[5], ins[6], ins[7], H, W)
    mask = raster_cuda.tile_sphere_mask(*cull)
    assert raster_cuda.check_lists(mask, *cull) == {"listed_beyond_twin": 0,
                                                     "twin_not_listed": 0}
    every = (ins[1] > 0)[:, None, :].expand_as(mask)
    assert raster_cuda.check_lists(every, *cull)["listed_beyond_twin"] > 0
    inner = raster_cuda.tile_sphere_mask(*cull, slack=-raster_cuda.TWIN_SLACK)
    dropped = mask.clone()
    dropped[torch.nonzero(inner)[0].unbind()] = False
    assert raster_cuda.check_lists(dropped, *cull) == {"listed_beyond_twin": 0,
                                                        "twin_not_listed": 1}


def test_kernel_source_states_the_wrappers_layout_and_margins():
    """csrc/raster.cu tiles the image, sizes its shared memory and its cull
    margin with the constants the wrapper and the twin use."""
    with open(SOURCE) as f:
        src = f.read()
    define = lambda name: float(re.search(rf"#define {name} ([0-9.e+-]+)f?\n", src).group(1))
    assert (define("TILE_W"), define("TILE_H")) == raster_cuda.TILE
    assert define("CULL_LINEAR") == raster_cuda.CULL_LINEAR
    assert define("CULL_QUADRATIC") == raster_cuda.CULL_QUADRATIC
    assert define("CONST_FLOATS") == raster_cuda.CONST_FLOATS
    assert "sizeof(float4) + sizeof(float) + sizeof(int)" in src  # 24 bytes per sphere
    assert raster_cuda.SPHERE_BYTES == 24
