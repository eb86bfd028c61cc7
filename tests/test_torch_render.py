"""Port renderer (the raster kernel's plain version) vs the JAX package.

`deep_rl_grasping_tpu_torch.render.raycast.render` (depth + seg, and RGB
with `with_rgb`) is held against the JAX `render/raycast.py:render` on the
cases of tests/test_render.py (metric depth, ids on floor and table, the
visibility helper), and against the JAX package's Pallas raster kernel
(`ops/raster_pallas.py`, interpret mode: depth, seg and the shade output)
wherever the gripper has yawed: the gripper in the wrist view and sampled
scenes seen from the wrist camera, OnFloor and OnTable, with the same
inputs. The JAX XLA renderer rotates ray directions into the gripper frame
by R where the Pallas kernel (and the port) use R^T (raycast.py:80 vs
raster_pallas.py:140-145), so with a yawed gripper the two JAX renderers
disagree on the finger pads; the port follows the kernel it replaces, which
keeps the fingers fixed in the wrist image as the rigid mount does.

Tolerance: depth to 1e-5 m (float32 ray algebra in another evaluation
order; depths are ~0.05-2 m), except against the kernel's own gathered
inputs, where 0.5% of pixels (edges) may differ by up to 5e-3 m as in
tests/test_torch_cuda.py. Segmentation ids must match exactly. Shade
and RGB to 1e-5 where the XLA renderer's arithmetic is followed, and
against the kernel, whose sphere shade comes from the ray parameter rather
than the hit point, to 1e-4 on all but 0.5% of pixels and 2e-2 on every
pixel (at a sphere's silhouette n.d -> 0 and the hit is ill-conditioned).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu.ops.raster_pallas import raster_depth_seg as pallas_raster
from deep_rl_grasping_tpu.ops.raster_pallas import render_batch_pallas
from deep_rl_grasping_tpu.render import raycast as jraycast
from deep_rl_grasping_tpu.sim import objects as jobjects
from deep_rl_grasping_tpu.sim import scene as jscene
from deep_rl_grasping_tpu.sim.types import ObjectState, SimState, make_sim_params
from deep_rl_grasping_tpu_torch.ops import raster_cuda
from deep_rl_grasping_tpu_torch.render import raycast as traycast
from deep_rl_grasping_tpu_torch.sim import objects as tobjects
from deep_rl_grasping_tpu_torch.sim import types as ttypes

H = W = 64
INTR = np.array([69.76, 77.25, 32.19, 32.0], np.float32)
DEPTH_TOL = 1e-5
LOOKDOWN_R = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], np.float32)
# wrist camera extrinsics (configs/camera_transform.yaml)
T_RC = np.array([0.0, 0.0573, 0.0451], np.float32)
Q_RC = np.array([0.0, -0.1305, 0.9914, 0.0], np.float32)


def to_numpy(state):
    out = {}
    for part in ("gripper", "objects"):
        sub = getattr(state, part)
        for f in dataclasses.fields(sub):
            out[f"{part}.{f.name}"] = np.asarray(getattr(sub, f.name))
    return out


def _params(scene_type):
    jp = make_sim_params(jobjects.get_library(8), scene_type=scene_type)
    tp = ttypes.make_sim_params(tobjects.get_library(8), scene_type=scene_type)
    return jp, tp


def _state(pos, types, gripper_height=5.0):
    K = len(pos)
    return SimState(
        gripper=jscene.init_gripper(gripper_height),
        objects=ObjectState(
            pos=jnp.asarray(pos, jnp.float32),
            quat=jnp.tile(jnp.array([0.0, 0.0, 0.0, 1.0]), (K, 1)),
            linvel=jnp.zeros((K, 3)), angvel=jnp.zeros((K, 3)),
            obj_type=jnp.asarray(types, jnp.int32), alive=jnp.ones(K, bool)))


def _render_both(jstate_batch, jp, tp, cam_pos, cam_R, intr, ref="xla"):
    """JAX render (the XLA renderer per env, or the Pallas kernel on the
    batch) and the port's render on the batch."""
    if ref == "xla":
        _, jd, js = jax.vmap(lambda s, p, r, i: jraycast.render(s, jp, p, r, i, H, W))(
            jstate_batch, jnp.asarray(cam_pos), jnp.asarray(cam_R), jnp.asarray(intr))
    else:
        jd, js = render_batch_pallas(jstate_batch, jp, jnp.asarray(cam_pos),
                                     jnp.asarray(cam_R), jnp.asarray(intr), interpret=True)
    ts = ttypes.sim_state_from_numpy(to_numpy(jstate_batch))
    t = lambda a: torch.tensor(np.array(a))
    td, tseg = traycast.render(ts, tp, t(cam_pos), t(cam_R), t(intr), H, W)
    return np.asarray(jd), np.asarray(js), td.numpy(), tseg.numpy()


def _batch(*states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _lookdown(params, n):
    pos = np.tile(np.array([[0.0, 0.0, params.support_z + 0.5]], np.float32), (n, 1))
    return pos, np.tile(LOOKDOWN_R, (n, 1, 1)), np.tile(INTR, (n, 1))


CASES = {
    # test_render.py:39 metric depth: empty floor
    "depth_is_metric_z": ("OnFloor", [[[10.0, 10.0, 0.0]]], [[1]], 5.0),
    # test_render.py:57 object id on the floor
    "object_id_onfloor": ("OnFloor", [[[0.0, 0.0, -0.17], [10.0, 10.0, 0.0]]], [[1, 2]], 5.0),
    # test_render.py:74 table, tray and object ids
    "ids_ontable": ("OnTable", [[[0.0, 0.0, -0.16]]], [[1]], 5.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_render_lookdown_cases_match_jax(case):
    scene_type, pos, types, gh = CASES[case]
    jp, tp = _params(scene_type)
    states = _batch(*[_state(p, t, gh) for p, t in zip(pos, types)])
    cam_pos, cam_R, intr = _lookdown(jp, len(pos))
    jd, js, td, tseg = _render_both(states, jp, tp, cam_pos, cam_R, intr)
    np.testing.assert_allclose(td, jd, atol=DEPTH_TOL, rtol=0)
    np.testing.assert_array_equal(tseg, js)
    if case == "depth_is_metric_z":
        assert abs(td[0, 32, 32] - 0.5) < 1e-3 and abs(td[0, 5, 5] - 0.5) < 1e-3


def _wrist_cameras(q):
    from deep_rl_grasping_tpu.utils import transforms as jt

    R_rc = np.asarray(jt.quat_to_matrix(jt.quat_normalize(jnp.asarray(Q_RC))))
    n = q.shape[0]
    jpos, jR = jax.vmap(lambda g: jraycast.camera_pose_from_gripper(
        g, jnp.asarray(T_RC), jnp.asarray(R_rc)))(jnp.asarray(q))
    tpos, tR = traycast.camera_pose_from_gripper(
        torch.as_tensor(q), torch.as_tensor(np.tile(T_RC, (n, 1))),
        torch.as_tensor(np.tile(R_rc, (n, 1, 1))))
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=1e-6)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-6)
    return np.asarray(jpos), np.asarray(jR)


def test_gripper_visible_in_wrist_view_matches_jax():
    """test_render.py:89: the fingers show up in the wrist camera with the
    gripper id; camera pose composition agrees with the JAX package. The
    gripper has yawed, so the reference is the Pallas kernel."""
    jp, tp = _params("OnFloor")
    q = np.array([[0.0, 0.0, 0.25, 0.3, 0.0, 0.0]], np.float32)
    s = _state([[10.0, 10.0, 0.0]], [1], 0.25)
    s = s.replace(gripper=s.gripper.replace(q=jnp.asarray(q[0])))
    cam_pos, cam_R = _wrist_cameras(q)
    jd, js, td, tseg = _render_both(_batch(s), jp, tp, cam_pos, cam_R, INTR[None], "pallas")
    np.testing.assert_allclose(td, jd, atol=DEPTH_TOL, rtol=0)
    np.testing.assert_array_equal(tseg, js)
    assert (tseg == 2).any()  # K=1 -> gripper id 2


@pytest.mark.parametrize("scene_type", ["OnFloor", "OnTable"])
def test_render_sampled_scenes_match_jax(scene_type):
    """Wrist-camera renders of sampled 5-object scenes, gripper high and
    low (fingers in view, objects close), as the env renders them; yawed
    grippers, so against the Pallas kernel."""
    jp, tp = _params(scene_type)
    B = 4

    def one(k):
        objects = jscene.sample_objects(k, jp, jnp.arange(706, 856, dtype=jnp.int32), 5,
                                        3, 5, jnp.asarray(0.1))
        return SimState(gripper=jscene.init_gripper(0.25), objects=objects)

    states = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(3), B))
    q = np.asarray(states.gripper.q).copy()
    q[2:, 2] = 0.08
    q[2:, 0:2] = np.asarray(states.objects.pos)[2:, 0, 0:2]
    q[:, 3] = [0.0, 0.7, -0.4, 1.2]
    q[1:3, 4:6] = 0.02
    states = states.replace(gripper=states.gripper.replace(q=jnp.asarray(q)))
    cam_pos, cam_R = _wrist_cameras(q)
    jd, js, td, tseg = _render_both(states, jp, tp, cam_pos, cam_R, np.tile(INTR, (B, 1)),
                                    "pallas")
    np.testing.assert_allclose(td, jd, atol=DEPTH_TOL, rtol=0)
    np.testing.assert_array_equal(tseg, js)
    obj0 = 3 if scene_type == "OnTable" else 1
    assert ((tseg >= obj0) & (tseg < obj0 + 5)).any(axis=(1, 2)).all()


def test_object_visible_helper_matches_jax():
    jp, tp = _params("OnFloor")
    states = _batch(_state([[0.0, 0.0, -0.17]], [1]), _state([[10.0, 10.0, 0.0]], [1]))
    cam_pos, cam_R, intr = _lookdown(jp, 2)
    _, js, _, tseg = _render_both(states, jp, tp, cam_pos, cam_R, intr)
    vis = traycast.object_visible(torch.as_tensor(tseg), tp, 1).numpy()
    ref = [bool(jraycast.object_visible(jnp.asarray(m), jp, 1)) for m in js]
    assert vis.tolist() == ref == [True, False]


def test_raster_wrapper_uses_plain_version_on_cpu():
    """render_batch takes raycast.render for CPU tensors; the kernel wrapper
    refuses CPU tensors instead of falling back."""
    jp, tp = _params("OnFloor")
    states = _batch(_state([[0.0, 0.0, -0.17]], [1]))
    cam_pos, cam_R, intr = _lookdown(jp, 1)
    ts = ttypes.sim_state_from_numpy(to_numpy(states))
    args = (ts, tp, torch.as_tensor(cam_pos), torch.as_tensor(cam_R), torch.as_tensor(intr))
    d1, s1 = raster_cuda.render_batch(*args, H=H, W=W)
    d2, s2 = traycast.render(*args, H, W)
    assert torch.equal(d1, d2) and torch.equal(s1, s2)
    with pytest.raises(ValueError):
        raster_cuda.raster_depth_seg(
            torch.zeros(1, 8, 3), torch.zeros(1, 8), torch.zeros(1, 8, dtype=torch.int32),
            torch.zeros(1, 3, 3), torch.eye(3)[None], torch.zeros(1, 3), torch.eye(3)[None],
            torch.as_tensor(intr), H=H, W=W, has_tray=False, plane_z=-0.196, near=0.02,
            far=2.0, tray_half=0.21, wall_height=0.062, gripper_id=2)



SHADE_TOL, SHADE_OVER_FRAC, SHADE_EDGE_TOL = 1e-4, 5e-3, 2e-2


@pytest.mark.parametrize("case", list(CASES))
def test_render_rgb_lookdown_cases_match_jax(case):
    """RGB (headlight shade x id color) against the XLA renderer on the
    test_render.py cases (no yaw), floor and table color tables."""
    scene_type, pos, types, gh = CASES[case]
    jp, tp = _params(scene_type)
    states = _batch(*[_state(p, t, gh) for p, t in zip(pos, types)])
    cam_pos, cam_R, intr = _lookdown(jp, len(pos))
    jrgb, jd, js = jax.vmap(lambda s, p, r, i: jraycast.render(s, jp, p, r, i, H, W))(
        states, jnp.asarray(cam_pos), jnp.asarray(cam_R), jnp.asarray(intr))
    ts = ttypes.sim_state_from_numpy(to_numpy(states))
    t = lambda a: torch.tensor(np.array(a))
    trgb, td, tseg = traycast.render(ts, tp, t(cam_pos), t(cam_R), t(intr), H, W, with_rgb=True)
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(js))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=DEPTH_TOL, rtol=0)
    np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), atol=1e-5, rtol=0)
    assert trgb.shape == (len(pos), H, W, 3) and float(trgb.max()) > 0.3


def _sampled_scene(scene_type):
    jp, tp = _params(scene_type)
    B = 4

    def one(k):
        objects = jscene.sample_objects(k, jp, jnp.arange(706, 856, dtype=jnp.int32), 5,
                                        3, 5, jnp.asarray(0.1))
        return SimState(gripper=jscene.init_gripper(0.25), objects=objects)

    states = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(5), B))
    q = np.asarray(states.gripper.q).copy()
    q[2:, 2] = 0.08
    q[2:, 0:2] = np.asarray(states.objects.pos)[2:, 0, 0:2]
    q[:, 3] = [0.3, -0.9, 0.0, 2.1]
    q[1:3, 4:6] = 0.02
    states = states.replace(gripper=states.gripper.replace(q=jnp.asarray(q)))
    cam_pos, cam_R = _wrist_cameras(q)
    return jp, tp, states, cam_pos, cam_R, np.tile(INTR, (B, 1))


@pytest.mark.parametrize("scene_type", ["OnFloor", "OnTable"])
def test_render_shade_and_rgb_match_pallas(scene_type):
    """The port's shade (render_shade) against the Pallas kernel's shade
    output on the kernel inputs the port gathers (raster_cuda.kernel_inputs),
    and the assembled RGB against render_batch_pallas(with_rgb=True)."""
    jp, tp, states, cam_pos, cam_R, intr = _sampled_scene(scene_type)
    ts = ttypes.sim_state_from_numpy(to_numpy(states))
    t = lambda a: torch.tensor(np.array(a))
    td, tseg, tshade = traycast.render_shade(ts, tp, t(cam_pos), t(cam_R), t(intr), H, W)
    args, kw = raster_cuda.kernel_inputs(ts, tp, t(cam_pos), t(cam_R), t(intr), H, W)
    jd, js, jshade = pallas_raster(
        *[jnp.asarray(a.numpy()) for a in args], H=H, W=W,
        plane_seg_mode="table" if kw["has_tray"] else "floor", plane_z=kw["plane_z"],
        near=kw["near"], far=kw["far"], tray_half=kw["tray_half"],
        wall_height=kw["wall_height"], gripper_id=kw["gripper_id"], interpret=True,
        with_shade=True)
    js, jshade = np.asarray(js), np.asarray(jshade)
    np.testing.assert_array_equal(tseg.numpy(), js)
    derr = np.abs(td.numpy() - np.asarray(jd))
    assert (derr > DEPTH_TOL).mean() <= SHADE_OVER_FRAC and derr.max() <= 5e-3
    err = np.abs(tshade.numpy() - np.where(js < 0, 0.0, jshade))
    assert (err > SHADE_TOL).mean() <= SHADE_OVER_FRAC and err.max() <= SHADE_EDGE_TOL
    assert float(tshade.min()) >= 0.0 and float(tshade.max()) <= 1.0
    assert (tshade.numpy() > 0.35).mean() > 0.9  # every hit pixel is lit

    jrgb, _, _ = render_batch_pallas(states, jp, jnp.asarray(cam_pos), jnp.asarray(cam_R),
                                     jnp.asarray(intr), interpret=True, with_rgb=True)
    trgb, _, _ = traycast.render(ts, tp, t(cam_pos), t(cam_R), t(intr), H, W, with_rgb=True)
    rerr = np.abs(trgb.numpy() - np.asarray(jrgb))
    assert (rerr > SHADE_TOL).mean() <= SHADE_OVER_FRAC and rerr.max() <= SHADE_EDGE_TOL


def test_finger_pads_stay_fixed_in_the_wrist_view():
    """The camera rides on the gripper, so the finger pads cover the same
    pixels whatever the yaw."""
    jp, tp = _params("OnFloor")
    yaws = [0.0, 0.4, 1.1, -2.5]
    q = np.tile(np.array([[0.0, 0.0, 0.25, 0.0, 0.01, 0.01]], np.float32), (len(yaws), 1))
    q[:, 3] = yaws
    s = _batch(*[_state([[10.0, 10.0, 0.0]], [1], 0.25)] * len(yaws))
    s = s.replace(gripper=s.gripper.replace(q=jnp.asarray(q)))
    cam_pos, cam_R = _wrist_cameras(q)
    ts = ttypes.sim_state_from_numpy(to_numpy(s))
    t = lambda a: torch.tensor(np.array(a))
    _, seg = traycast.render(ts, tp, t(cam_pos), t(cam_R), t(np.tile(INTR, (len(yaws), 1))),
                             H, W)
    pads = seg == 2
    assert int(pads[0].sum()) > 100
    for i in range(1, len(yaws)):
        assert int((pads[i] != pads[0]).sum()) <= 4, yaws[i]


def test_rgb_render_uses_plain_version_on_cpu():
    """render_batch(with_rgb=True) takes the plain version for CPU tensors;
    the kernel wrapper refuses CPU tensors with the shade output as well."""
    jp, tp, states, cam_pos, cam_R, intr = _sampled_scene("OnTable")
    ts = ttypes.sim_state_from_numpy(to_numpy(states))
    t = lambda a: torch.tensor(np.array(a))
    a = raster_cuda.render_batch(ts, tp, t(cam_pos), t(cam_R), t(intr), H=H, W=W,
                                 with_rgb=True)
    b = traycast.render(ts, tp, t(cam_pos), t(cam_R), t(intr), H, W, with_rgb=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    args, kw = raster_cuda.kernel_inputs(ts, tp, t(cam_pos), t(cam_R), t(intr), H, W)
    with pytest.raises(ValueError):
        raster_cuda.raster_depth_seg(*args, **kw, with_shade=True)


def test_shade_gap_admits_either_sphere_only_at_a_crease():
    """raycast.shade_gap, the kernel checks' shade comparison: 0 for the
    plain version's own shade; at a crease between two spheres of one
    object (hits within tie_tol) either sphere's shade is admitted; any
    other change of the shade shows in full."""
    _, tp, states, cam_pos, cam_R, intr = _sampled_scene("OnFloor")
    ts = ttypes.sim_state_from_numpy(to_numpy(states))
    t = lambda a: torch.tensor(np.array(a))
    args = (ts, tp, t(cam_pos), t(cam_R), t(intr), H, W)
    _, seg, shade = traycast.render_shade(*args)
    cand = traycast.hit_candidates(*args)
    assert float(traycast.shade_gap(seg, shade, cand, 0.0).abs().max()) == 0.0
    # crease pixels: the two nearest hits share the object id, lie within
    # 1e-3 m and differ in shade
    tc, ids, sh = cand
    t2, i2 = torch.topk(tc, 2, dim=-1, largest=False)
    id2, sh2 = torch.gather(ids, -1, i2), torch.gather(sh, -1, i2)
    crease = ((id2[..., 0] == id2[..., 1]) & (id2[..., 0] > 0) & (t2[..., 1] - t2[..., 0] < 1e-3)
              & ((sh2[..., 1] - sh2[..., 0]).abs() > 0.02))
    assert int(crease.sum()) > 0
    b, p = [int(x) for x in torch.nonzero(crease)[0]]
    other = shade.clone().reshape(shade.shape[0], -1)
    other[b, p] = sh2[b, p, 1]
    other = other.reshape(shade.shape)
    assert float(traycast.shade_gap(seg, other, cand, 1e-3).max()) == 0.0
    assert float(traycast.shade_gap(seg, other, cand, 0.0).max()) > 0.02
    off = shade + 0.5 * (seg == 1)  # object 1's pixels, off the winner's shade
    gap = traycast.shade_gap(seg, off, cand, 0.0)
    assert torch.allclose(gap[seg == 1], torch.full_like(gap[seg == 1], 0.5), atol=1e-6)
