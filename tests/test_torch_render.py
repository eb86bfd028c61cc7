"""Port renderer (the raster kernel's plain version) vs the JAX package.

`deep_rl_grasping_tpu_torch.render.raycast.render` (depth + seg) is held
against the JAX `render/raycast.py:render` on the cases of
tests/test_render.py (metric depth, ids on floor and table, the gripper in
the wrist view, the visibility helper) and on sampled scenes seen from the
wrist camera, OnFloor and OnTable, with the same inputs.

Tolerance: depth to 1e-5 m (float32 ray algebra in another evaluation
order; depths are ~0.05-2 m). Segmentation ids must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _render_both(jstate_batch, jp, tp, cam_pos, cam_R, intr):
    """JAX render per env (vmap) and port render on the batch."""
    _, jd, js = jax.vmap(lambda s, p, r, i: jraycast.render(s, jp, p, r, i, H, W))(
        jstate_batch, jnp.asarray(cam_pos), jnp.asarray(cam_R), jnp.asarray(intr))
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
    gripper id; camera pose composition agrees with the JAX package."""
    jp, tp = _params("OnFloor")
    q = np.array([[0.0, 0.0, 0.25, 0.3, 0.0, 0.0]], np.float32)
    s = _state([[10.0, 10.0, 0.0]], [1], 0.25)
    s = s.replace(gripper=s.gripper.replace(q=jnp.asarray(q[0])))
    cam_pos, cam_R = _wrist_cameras(q)
    jd, js, td, tseg = _render_both(_batch(s), jp, tp, cam_pos, cam_R, INTR[None])
    np.testing.assert_allclose(td, jd, atol=DEPTH_TOL, rtol=0)
    np.testing.assert_array_equal(tseg, js)
    assert (tseg == 2).any()  # K=1 -> gripper id 2


@pytest.mark.parametrize("scene_type", ["OnFloor", "OnTable"])
def test_render_sampled_scenes_match_jax(scene_type):
    """Wrist-camera renders of sampled 5-object scenes, gripper high and
    low (fingers in view, objects close), as the env renders them."""
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
    jd, js, td, tseg = _render_both(states, jp, tp, cam_pos, cam_R, np.tile(INTR, (B, 1)))
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

