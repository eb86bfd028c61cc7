"""The scripted grasp expert of the full 5-d continuous task (port of
deep_rl_grasping_tpu/envs/scripted.py: `_yaw_align` :26,
`scripted_full_action` :78), batched over the env axis.

Servo over the nearest alive object, descend when centred, close at grasp
height once the pinch axis is aligned with the object's minor axis, lift
while holding. The trainer seeds the replay with its transitions
(`Trainer.seed_demos`). The move noise, the random action and the choice
to take it are drawn from an explicit `torch.Generator`. The discrete,
branched and simplified experts are not ported yet.
"""

from __future__ import annotations

import math

import torch

from deep_rl_grasping_tpu_torch.sim import physics
from deep_rl_grasping_tpu_torch.sim.types import PAD_CENTER_DEPTH, PAD_HALF_EXTENTS


def _yaw_align(env, state, k):
    """Yaw action in [-1, 1] that turns the pinch axis perpendicular to the
    horizontal major axis of object slot k (B,), and the physical alignment
    error in radians. The major axis comes from the radius^3-weighted second
    moment of the object's world sphere centres; near-isotropic objects
    (anisotropy <= 0.15) get no yaw command. The servo feedback is the
    commanded yaw (-ee_angle), not the lagging joint (scripted.py:26-75)."""
    centers, radii, mask = physics.world_spheres(state.sim, env.sim_params)
    bi = torch.arange(k.shape[0], device=k.device)
    c = centers[bi, k, :, :2]
    r = radii[bi, k]
    w = mask[bi, k].to(torch.float32) * r ** 3
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    mu = (w[..., None] * c).sum(1) / wsum[:, None]
    d = c - mu[:, None]
    cov = (w[..., None, None] * (d[..., :, None] * d[..., None, :])).sum(1) / wsum[:, None, None]
    self_tr = 2.0 * (w * r ** 2 / 5.0).sum(-1) / wsum
    gap = torch.hypot(cov[:, 0, 0] - cov[:, 1, 1], 2.0 * cov[:, 0, 1])
    aniso = gap / torch.clamp(cov[:, 0, 0] + cov[:, 1, 1] + self_tr, min=1e-12)
    theta_maj = 0.5 * torch.atan2(2.0 * cov[:, 0, 1], cov[:, 0, 0] - cov[:, 1, 1])
    want = theta_maj + math.pi / 2.0

    def wrap(e):  # to [-pi/2, pi/2): the pinch is symmetric mod pi
        return torch.remainder(e + math.pi / 2.0, math.pi) - math.pi / 2.0

    isotropic = aniso <= 0.15
    zero = torch.zeros_like(want)
    g = state.sim.gripper
    perr = torch.where(isotropic, zero, wrap(want - g.q[:, 3]))
    cerr = torch.where(isotropic, zero, wrap(want + g.ee_angle))
    act = torch.clamp(-cerr / env.actuator_spec.max_yaw_rotation, -1.0, 1.0)
    return act, perr


def scripted_full_action(env, state, gen: torch.Generator, noise=0.1, p_random=0.1):
    """Expert actions (B, 5) for the full continuous task. `noise` jitters
    the move dims and `p_random` replaces the whole action by a uniform one,
    both only before the expert engages (centred over the object or
    holding), so exploration never spoils a grasp (scripted.py:78-150)."""
    g = state.sim.gripper
    obj = state.sim.objects
    mt = env.actuator_spec.max_translation
    B, dev = g.q.shape[0], g.q.device
    bi = torch.arange(B, device=dev)

    d2 = ((obj.pos[..., :2] - g.q[:, None, :2]) ** 2).sum(-1)
    d2 = torch.where(obj.alive, d2, torch.full_like(d2, float("inf")))
    k = torch.argmin(d2, -1)
    tx, ty = obj.pos[bi, k, 0], obj.pos[bi, k, 1]

    cy, sy = torch.cos(g.q[:, 3]), torch.sin(g.q[:, 3])
    wx, wy = tx - g.q[:, 0], ty - g.q[:, 1]
    # the hand frame is flipped (roll = pi): local +z is world down, local y flips
    ldx = cy * wx + sy * wy
    ldy = -(-sy * wx + cy * wy)
    dx = torch.clamp(ldx / mt, -1.0, 1.0)
    dy = torch.clamp(ldy / mt, -1.0, 1.0)

    floor_q2 = env.sim_params.support_z + PAD_CENTER_DEPTH + PAD_HALF_EXTENTS[2]
    near_xy = (torch.abs(wx) < 0.005) & (torch.abs(wy) < 0.005)
    low = g.q[:, 2] < floor_q2 + 0.01
    closed = g.gripper_close
    # an empty closed gripper (a spurious close) is reopened
    width = physics.gripper_width(g.q)
    empty_closed = closed & (width <= 0.005)
    holding = closed & ~empty_closed

    yaw_act, yaw_perr = _yaw_align(env, state, k)
    zero, one = torch.zeros_like(dx), torch.ones_like(dx)
    dyaw = torch.where(closed, zero, yaw_act)
    aligned = torch.abs(yaw_perr) < 0.25
    do_close = ~closed & near_xy & low & aligned
    oc = torch.where(do_close, -one, torch.where(empty_closed, one, zero))
    dz = torch.where(holding, -one, torch.where(near_xy, one, zero))
    dx = torch.where(closed, zero, dx)
    dy = torch.where(closed, zero, dy)

    engaged = closed | near_xy
    eff_noise = torch.where(engaged, zero, torch.full_like(dx, noise))
    move = torch.stack([dx, dy, dz, dyaw], -1)
    n = torch.randn((B, 4), generator=gen, device=dev)
    move = torch.clamp(move + eff_noise[:, None] * n, -1.0, 1.0)
    a = torch.cat([move, oc[:, None]], -1)
    rand_a = torch.rand((B, 5), generator=gen, device=dev) * 2.0 - 1.0
    use_rand = (torch.rand((B,), generator=gen, device=dev) < p_random) & ~engaged
    return torch.where(use_rand[:, None], rand_a, a)
