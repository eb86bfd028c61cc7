"""Port physics (the solver kernel's plain version) vs the JAX package.

`deep_rl_grasping_tpu_torch.sim.physics.run` is held against the JAX
`sim.physics.run` from identical states (built with the JAX package and
passed through numpy) on the scenarios of tests/test_solver_pallas.py:
freefall settle, servo move, grasp squeeze, tray-wall contact, tray squeeze,
the object-object knobs and pinch damping.

Tolerance: both sides run the same float32 algorithm; they differ only in
summation order (segment sums, einsum contractions), so the gap starts at
float32 rounding (~1e-7) and grows through the contact solve, most in the
angular velocities of objects in contact. Positions and gripper
coordinates are held to 1e-5, quaternions and velocities to 1e-4, angular
velocities to 1e-2 rad/s (about 30x the largest gap seen on these cases).

Sizes are cut for the CPU: B=2 envs per scenario, K=3 object slots, 8
substeps at the flagship's dt and solver schedule (4 iterations x 6 pad
passes); one parameter set turns both object-object knobs off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_rl_grasping_tpu.sim import objects as jobjects
from deep_rl_grasping_tpu.sim import physics as jphysics
from deep_rl_grasping_tpu.sim import scene as jscene
from deep_rl_grasping_tpu.sim.types import FINGER_CLOSED, SimState, make_sim_params
from deep_rl_grasping_tpu_torch.ops import solver_cuda
from deep_rl_grasping_tpu_torch.sim import objects as tobjects
from deep_rl_grasping_tpu_torch.sim import physics as tphysics
from deep_rl_grasping_tpu_torch.sim import types as ttypes

TOL = {"gripper.q": 1e-5, "gripper.qd": 1e-4, "objects.pos": 1e-5, "objects.quat": 1e-4,
       "objects.linvel": 1e-4, "objects.angvel": 1e-2}
N_SUB = 8
B = 2
# The flagship's solver schedule (trained/sac_full_flagship_r5c/config.yaml).
FLAGSHIP = dict(dt=0.0125, solver_iterations=4, pad_inner_iterations=6,
                oo_point_mass_tangent=True, oo_pass_stride=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(state):
    out = {}
    for part in ("gripper", "objects"):
        sub = getattr(state, part)
        for f in dataclasses.fields(sub):
            out[f"{part}.{f.name}"] = np.asarray(getattr(sub, f.name))
    return out


def _states(params, key, height):
    def one(k):
        objects = jscene.sample_objects(
            k, params, jnp.arange(6, 106, dtype=jnp.int32), 3, 2, 3, jnp.asarray(0.03))
        return SimState(gripper=jscene.init_gripper(height), objects=objects)
    return jax.vmap(one)(jax.random.split(key, B))


def _freefall(params, key):
    s = _states(params, key, 0.15)
    return s.replace(objects=s.objects.replace(pos=s.objects.pos + jnp.array([0.0, 0.0, 0.01])))


def _servo(params, key):
    s = _states(params, key, 0.15)
    tgt = jnp.tile(jnp.asarray([0.02, -0.015, 0.09, 0.4]), (B, 1))
    return s.replace(gripper=s.gripper.replace(target=tgt))


def _squeeze(params, key, height=0.08):
    s = _states(params, key, height)
    g = s.gripper
    q = g.q.at[:, 4:6].set(0.02)
    return s.replace(gripper=g.replace(
        q=q, target=q[:, :4], finger_target=jnp.full((B,), FINGER_CLOSED),
        gripper_close=jnp.ones((B,), bool)))


def _tray_wall(params, key):
    s = _states(params, key, 0.15)
    obj = s.objects
    k = obj.pos.shape[1]
    edge = params.tray_half - 0.03
    dirs = jnp.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
    d = jnp.broadcast_to(dirs[jnp.arange(k) % 4], (B, k, 2))
    pos = obj.pos.at[:, :, :2].set(d * edge * 0.7)
    vel = obj.linvel.at[:, :, :2].set(d * 0.8)
    return s.replace(objects=obj.replace(pos=pos, linvel=vel))


def _pile(params, key):
    """Objects pushed together so object-object contacts start active."""
    s = _states(params, key, 0.15)
    pos = s.objects.pos.at[:, :, :2].multiply(0.3)
    return s.replace(objects=s.objects.replace(pos=pos))


def _pinch(params, key):
    return _squeeze(params, key, height=0.11)


# param set -> (scene type, overrides, {scenario: function making its states})
PARAM_SETS = {
    "floor": ("OnFloor", FLAGSHIP, {"freefall": _freefall, "servo_move": _servo,
                                    "grasp_squeeze": _squeeze, "pile_knobs_on": _pile}),
    "table": ("OnTable", FLAGSHIP, {"tray_wall": _tray_wall, "tray_squeeze": _squeeze}),
    "knobs_off": ("OnFloor", dict(FLAGSHIP, oo_point_mass_tangent=False, oo_pass_stride=1),
                  {"pile_knobs_off": _pile}),
    "pinch": ("OnFloor", dict(FLAGSHIP, pinch_damping=0.2), {"pinch_damping": _pinch}),
}
SCENARIOS = [(ps, name) for ps, (_, _, sc) in PARAM_SETS.items() for name in sc]

_cache = {}


def _run_param_set(ps):
    """One JAX compile per parameter set: all its scenarios run as one batch."""
    if ps in _cache:
        return _cache[ps]
    scene_type, overrides, scenarios = PARAM_SETS[ps]
    jlib = jobjects.get_library(8, oo_spheres=3)
    jp = make_sim_params(jlib, scene_type=scene_type, **overrides)
    tp = ttypes.make_sim_params(tobjects.get_library(8, oo_spheres=3),
                                scene_type=scene_type, **overrides)
    parts = [build(jp, jax.random.PRNGKey(i)) for i, build in enumerate(scenarios.values())]
    states = jax.tree.map(lambda *xs: jnp.concatenate(xs), *parts)
    ref = to_numpy(jax.jit(jax.vmap(lambda s: jphysics.run(s, jp, N_SUB)))(states))
    ts = ttypes.sim_state_from_numpy(to_numpy(states))
    out = ttypes.sim_state_to_numpy(tphysics.run(ts, tp, N_SUB))
    _cache[ps] = (list(scenarios), ref, out, to_numpy(states))
    return _cache[ps]


@pytest.mark.parametrize("ps,name", SCENARIOS, ids=[n for _, n in SCENARIOS])
def test_physics_run_matches_jax(ps, name):
    names, ref, out, _ = _run_param_set(ps)
    sl = slice(names.index(name) * B, (names.index(name) + 1) * B)
    for key, tol in TOL.items():
        np.testing.assert_allclose(out[key][sl], ref[key][sl], atol=tol, rtol=0, err_msg=key)
    # grasp detection (width > 5 mm) must agree exactly
    w = lambda d: (0.05 - d["gripper.q"][sl, 4]) + (0.05 - d["gripper.q"][sl, 5])
    np.testing.assert_array_equal(w(out) > 0.005, w(ref) > 0.005)


def _active(ps, name, which):
    """Active contact rows per category at the start and the end of a
    scenario: (statics, left pad, right pad, object pairs)."""
    names, _, out, start = _run_param_set(ps)
    sl = slice(names.index(name) * B, (names.index(name) + 1) * B)
    scene_type, overrides, _ = PARAM_SETS[ps]
    tp = ttypes.make_sim_params(tobjects.get_library(8, oo_spheres=3),
                                scene_type=scene_type, **overrides)
    d = {"start": start, "end": out}[which]
    st = ttypes.sim_state_from_numpy({k: v[sl] for k, v in d.items()})
    c = tphysics._collect_contacts(st, tp)
    b = c["bounds"]
    return [int(c["active"][:, b[i]:b[i + 1]].sum()) for i in range(4)]


@pytest.mark.parametrize("ps,name,cat,which", [
    ("floor", "grasp_squeeze", 1, "end"), ("table", "tray_squeeze", 2, "end"),
    ("pinch", "pinch_damping", 2, "end"), ("floor", "pile_knobs_on", 3, "start"),
    ("knobs_off", "pile_knobs_off", 3, "start"), ("table", "tray_wall", 0, "end"),
])
def test_scenarios_exercise_their_contacts(ps, name, cat, which):
    """Each scenario really drives the contact category it is there for
    (pads for the squeezes, object pairs for the knobs, statics for the
    walls), so the comparison above is not of free motion only."""
    assert _active(ps, name, which)[cat] > 0


def test_solver_wrapper_uses_plain_version_on_cpu():
    """run_batched_sim takes physics.run for CPU tensors (bit-identical), and
    the kernel wrapper refuses CPU tensors instead of falling back."""
    _, _, out, start = _run_param_set("floor")
    tp = ttypes.make_sim_params(tobjects.get_library(8, oo_spheres=3), scene_type="OnFloor",
                                **FLAGSHIP)
    ts = ttypes.sim_state_from_numpy(start)
    got = ttypes.sim_state_to_numpy(solver_cuda.run_batched_sim(ts, tp, N_SUB))
    for key in TOL:
        np.testing.assert_array_equal(got[key], out[key])
    g = ts.gripper
    with pytest.raises(ValueError):
        solver_cuda.run_batch(g.q, g.qd, g.target, g.finger_target, ts.objects.pos,
                              ts.objects.quat, ts.objects.linvel, ts.objects.angvel,
                              ts.objects.alive.float(), None, torch.zeros(1, 1, 1), None,
                              torch.zeros(1, 1, 1), None, None, params=tp, n_substeps=1)



# Shared-memory request of the solver kernel, from its table widths (23
# floats per static row, 25 per pad row, 26 per object-pair row, 35 per
# body, 7 per sphere, one cross mass per pad slot, and the impulse scratch:
# 6 floats per row, 12 per pair row, for the widest category).
def _shared_bytes(K, S, SC, NS):
    KS, NOO = K * S, K * (K - 1) // 2 * SC * SC
    scratch = max(6 * max(NS * KS, 2 * KS), 12 * NOO)
    return 4 * (23 * NS * KS + 25 * 2 * KS + 26 * NOO + 35 * K + 7 * KS + 7 * K * SC + KS
                + scratch)


@pytest.mark.parametrize("B,K,S,SC,tray", [(100, 5, 8, 3, False), (128, 5, 8, 3, False),
                                           (32, 5, 8, 3, True)],
                         ids=["eval_flagship", "train_flagship", "table"])
def test_solver_launch_config_flagship(B, K, S, SC, tray):
    """One block per env of whole warps (two: one thread per pad row of the
    flagship); the eval and train flagships (K=5, S=8, SC=3, no tray) ask
    for 27,760 bytes, under the 48 KB a block gets without opting in."""
    cfg = solver_cuda.launch_config(B, K, S, SC, tray)
    assert cfg["blocks"] == B
    assert cfg["threads"] % 32 == 0 and cfg["threads"] >= K * S
    assert cfg["shared_bytes"] == _shared_bytes(K, S, SC, 5 if tray else 1)
    if not tray:
        assert cfg["shared_bytes"] == 27_760 < 48 * 1024


def test_solver_launch_config_limits():
    """Every shape the kernel takes (K <= 6, S <= 8, SC <= 4, with or
    without the tray) fits in the 232,448 bytes of shared memory a Hopper
    block can opt into; the largest, K=6, S=8, SC=4 with the tray, asks
    for 71,208."""
    sizes = {(K, S, SC, tray): solver_cuda.launch_config(1, K, S, SC, tray)["shared_bytes"]
             for K in range(1, 7) for S in range(1, 9) for SC in range(1, 5)
             for tray in (False, True)}
    assert max(sizes.values()) == sizes[(6, 8, 4, True)] == _shared_bytes(6, 8, 4, 5) == 71_208
    assert max(sizes.values()) < 232_448
    assert min(sizes.values()) > 0
