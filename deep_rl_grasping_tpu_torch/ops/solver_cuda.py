"""Contact-solver substep loop: CUDA kernel wrapper and its plain version.

Replaces deep_rl_grasping_tpu/ops/solver_pallas.py (the Pallas TPU kernel
`_make_kernel` :107, driven by `run_batch` :1037 / `run_batched_sim`
:1126). The kernel is `csrc/solver.cu` (one block of two warps per env,
the env's contact rows in shared memory, the whole substep loop in one
launch); its plain PyTorch version is `sim.physics.run`. On the H100 it
is bound by the chain of dependent solver phases, not by bytes or FLOPs
(see the note at the top of csrc/solver.cu). `launch_config` gives the launch shape and the
shared-memory size that the C entry checks and launches with.

`run_batched_sim` takes the plain version only for a state whose tensors
lie on the CPU. For CUDA tensors it launches the kernel or raises; it never
falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deep_rl_grasping_tpu_torch.ops import build
from deep_rl_grasping_tpu_torch.sim import physics
from deep_rl_grasping_tpu_torch.sim.types import SimParams, SimState


def _float_params(p: SimParams):
    vals = [
        p.dt, p.support_z, p.tray_half, p.tray_wall_height, p.friction, p.baumgarte,
        p.slop, p.relaxation, p.gravity, p.lin_damping, p.ang_damping,
        p.max_bias_velocity, p.warm_start, p.pad_omega, p.pad_bias_scale,
        p.rolling_damping, p.pinch_damping,
        *p.dof_mass, *p.dof_force, *p.dof_vmax,
    ]
    return np.asarray(vals, np.float32)


# Shared-memory table widths in floats, as csrc/solver.cu lays them out:
# fields per static row, pad row and object-pair row, per body, per sphere.
ST_FIELDS, PD_FIELDS, OO_FIELDS, BODY_FIELDS, SPH_FIELDS = 23, 25, 26, 35, 7
THREADS_PER_ENV = 64  # two warps; csrc/solver.cu THREADS_PER_ENV


def launch_config(B: int, K: int, S: int, SC: int, has_tray: bool) -> dict:
    """Launch shape of the solver kernel: one block of two warps per env,
    with the env's rows, bodies, sphere tables and impulse scratch in
    dynamic shared memory sized by the actual K, S, SC and tray walls
    (csrc/solver.cu `solver_layout`)."""
    NS = 5 if has_tray else 1
    KS = K * S
    NOO = K * (K - 1) // 2 * SC * SC
    NST, NPD = NS * KS, 2 * KS
    floats = (ST_FIELDS * NST + PD_FIELDS * NPD + OO_FIELDS * NOO + BODY_FIELDS * K
              + SPH_FIELDS * KS + SPH_FIELDS * K * SC + KS
              + max(6 * max(NST, NPD), 12 * NOO))
    return {"blocks": int(B), "threads": THREADS_PER_ENV, "shared_bytes": 4 * floats}


def int_params(B, K, S, SC, n_substeps, params: SimParams, threads, shared_bytes):
    """The C entry's int block: shapes, schedule, flags, launch shape."""
    return np.asarray([B, K, S, SC, int(n_substeps), int(params.solver_iterations),
                       int(params.pad_inner_iterations), int(params.oo_pass_stride),
                       int(bool(params.has_tray)), int(bool(params.oo_point_mass_tangent)),
                       int(threads), int(shared_bytes)], np.int32)


def kernel_attributes() -> dict:
    """The compiled kernel's registers per thread, local (stack and spill)
    bytes per thread, the most threads a block may have and its static
    shared bytes (needs the card)."""
    out = (ctypes.c_int * 4)()
    build.check(build.library().solver_attributes(ctypes.addressof(out)), "solver_attributes")
    return {"registers": out[0], "local_bytes": out[1], "max_threads_per_block": out[2],
            "static_shared_bytes": out[3]}


def run_batch(gq, gqd, gtarget, gftgt, opos, oquat, olin, oang, oalive,
              centers, radii, oo_centers, oo_radii, inv_mass, inv_inertia,
              params: SimParams, n_substeps: int):
    """Launch the solver kernel on env-first CUDA tensors (the layout of
    solver_pallas.run_batch). Returns (q, qd, pos, quat, linvel, angvel)."""
    dev = gq.device
    if dev.type != "cuda":
        raise ValueError("run_batch launches the CUDA kernel; pass CUDA tensors")
    B, K, S = radii.shape
    SC = oo_radii.shape[2]
    lib = build.library()
    lim = (ctypes.c_int * 3)()
    lib.solver_limits(ctypes.addressof(lim))
    if K > lim[0] or S > lim[1] or SC > lim[2]:
        raise ValueError(f"solver kernel supports K<={lim[0]}, S<={lim[1]}, SC<={lim[2]}; "
                         f"got K={K}, S={S}, SC={SC}")
    ins = dict(gq=(gq, (B, 6)), gqd=(gqd, (B, 6)), gtarget=(gtarget, (B, 4)),
               gftgt=(gftgt, (B,)), opos=(opos, (B, K, 3)), oquat=(oquat, (B, K, 4)),
               olin=(olin, (B, K, 3)), oang=(oang, (B, K, 3)), oalive=(oalive, (B, K)),
               centers=(centers, (B, K, S, 3)), radii=(radii, (B, K, S)),
               oo_centers=(oo_centers, (B, K, SC, 3)), oo_radii=(oo_radii, (B, K, SC)),
               inv_mass=(inv_mass, (B, K)), inv_inertia=(inv_inertia, (B, K, 3)))
    for name, (t, shape) in ins.items():
        build.check_tensor(t, name, shape, dev)
    outs = [torch.empty((B, 6), dtype=torch.float32, device=dev),
            torch.empty((B, 6), dtype=torch.float32, device=dev),
            torch.empty((B, K, 3), dtype=torch.float32, device=dev),
            torch.empty((B, K, 4), dtype=torch.float32, device=dev),
            torch.empty((B, K, 3), dtype=torch.float32, device=dev),
            torch.empty((B, K, 3), dtype=torch.float32, device=dev)]
    fp = _float_params(params)
    cfg = launch_config(B, K, S, SC, bool(params.has_tray))
    ip = int_params(B, K, S, SC, n_substeps, params, cfg["threads"], cfg["shared_bytes"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.solver_run(
            fp.ctypes.data, ip.ctypes.data,
            *[t.data_ptr() for t, _ in ins.values()],
            *[o.data_ptr() for o in outs], stream)
    build.check(err, "solver_kernel")
    run_batch.launches += 1
    return tuple(outs)


run_batch.launches = 0


def kernel_inputs(states: SimState, params: SimParams):
    """The kernel's env-first inputs: state plus per-env library geometry
    gathered by object type (what solver_pallas.run_batched_sim gathers)."""
    g, o = states.gripper, states.objects
    t = o.obj_type
    c = lambda x: x.to(torch.float32).contiguous()
    return (c(g.q), c(g.qd), c(g.target), c(g.finger_target), c(o.pos), c(o.quat),
            c(o.linvel), c(o.angvel), c(o.alive), c(params.centers[t]), c(params.radii[t]),
            c(params.oo_centers[t]), c(params.oo_radii[t]), c(params.inv_mass[t]),
            c(params.inv_inertia[t]))


def run_batched_sim(states: SimState, params: SimParams, n_substeps: int) -> SimState:
    """Advance a batch of envs `n_substeps` substeps: the plain version
    (`physics.run`) for CPU tensors, the CUDA kernel for CUDA tensors."""
    g, o = states.gripper, states.objects
    if g.q.device.type == "cpu":
        return physics.run(states, params, n_substeps)
    if g.q.device.type != "cuda":
        raise ValueError(f"unsupported device {g.q.device}")
    q, qd, pos, quat, lin, ang = run_batch(
        *kernel_inputs(states, params), params=params, n_substeps=n_substeps)
    return SimState(gripper=g.replace(q=q, qd=qd),
                    objects=o.replace(pos=pos, quat=quat, linvel=lin, angvel=ang))
