"""Batched impulse-based rigid-body physics (plain PyTorch).

Port of deep_rl_grasping_tpu/sim/physics.py (`substep` :674, `run` :741)
with the env axis B written out where the JAX package uses `vmap`. This is
the plain version of the solver kernel (ops/solver_cuda.py,
csrc/solver.cu): the kernel is held against it on the card, and the CPU
tests hold it against the JAX `physics.run`.

Per substep: free-velocity update and servo plan; fixed-size contact
arrays (spheres vs support plane, tray walls, finger pads; coarse object
spheres vs each other); warm start gated by normal continuity;
`solver_iterations` rounds of [statics; `pad_inner_iterations` x (motor
rows, coupled left/right pad rows); object-object every `oo_pass_stride`
rounds], each category relaxed-Jacobi within; rolling and pinch damping;
integration with finger limits and the fingertip floor stop.
"""

from __future__ import annotations

import torch

from deep_rl_grasping_tpu_torch.sim.types import (
    FINGER_LIMIT_HIGH,
    FINGER_LIMIT_LOW,
    PAD_CENTER_DEPTH,
    PAD_HALF_EXTENTS,
    PAD_X_OFFSET,
    GripperState,
    ObjectState,
    SimParams,
    SimState,
)

FINGER_CLOSED_WIDTH = 0.05


def yaw_rotation(yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1), torch.stack([z, z, o], -1)],
        -2,
    )


def quat_to_matrix(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        -1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def _norm(x, dim=-1, keepdim=False):
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)


def world_spheres(state: SimState, params: SimParams):
    """World-space sphere centers (B,K,S,3), radii (B,K,S), mask (B,K,S)."""
    obj = state.objects
    R = quat_to_matrix(obj.quat)
    local = params.centers[obj.obj_type]
    centers = obj.pos[:, :, None, :] + torch.einsum("bkij,bksj->bksi", R, local)
    radii = params.radii[obj.obj_type]
    mask = (radii > 0.0) & obj.alive[:, :, None]
    return centers, radii, mask


def pad_frames(q):
    """Gripper base (B,3), yaw frame (B,3,3), pad centers (B,2,3) and pad
    drive axes (B,2,3), world frame."""
    base = q[:, :3]
    R = yaw_rotation(q[:, 3])
    ex = R[:, :, 0]
    ez = torch.zeros_like(base)
    ez[:, 2] = 1.0
    c_l = base - ex * (PAD_X_OFFSET - q[:, 4:5]) - ez * PAD_CENTER_DEPTH
    c_r = base + ex * (PAD_X_OFFSET - q[:, 5:6]) - ez * PAD_CENTER_DEPTH
    return base, R, torch.stack([c_l, c_r], 1), torch.stack([ex, -ex], 1)


def _sphere_box_contact(center, radius, box_center, box_R, half_extents,
                        inside_axis, inside_sign):
    """Sphere (B,N,3),(B,N) vs one OBB per env (center (B,3), rotation
    (B,3,3)). Returns normal box->sphere, penetration, contact point and
    touching flag. A sphere whose center is inside the box is pushed out
    along the fixed `inside_axis` with `inside_sign` (physics.py:113)."""
    d = center - box_center[:, None, :]
    local = torch.einsum("bji,bnj->bni", box_R, d)
    he = torch.tensor(half_extents, dtype=center.dtype, device=center.device)
    clamped = torch.maximum(torch.minimum(local, he), -he)
    delta = local - clamped
    dist = _norm(delta)
    outside = dist > 1e-9
    n_out = torch.where(outside[..., None], delta / torch.clamp(dist, min=1e-9)[..., None],
                        torch.zeros_like(delta))
    n_in = torch.zeros_like(delta)
    n_in[..., inside_axis] = inside_sign
    n_local = torch.where(outside[..., None], n_out, n_in)
    pen_in = radius + half_extents[inside_axis] - inside_sign * local[..., inside_axis]
    pen = torch.where(outside, radius - dist, pen_in)
    n_world = torch.einsum("bij,bnj->bni", box_R, n_local)
    point = center - n_world * radius[..., None]
    return n_world, pen, point, pen > 0.0


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _tangent_basis(n):
    use_x = (torch.abs(n[..., 0:1]) < 0.9)
    ax = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ay = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    a = torch.where(use_x, ax, ay)
    t1 = _cross(n, a)
    t1 = t1 / torch.clamp(_norm(t1, keepdim=True), min=1e-9)
    t2 = _cross(n, t1)
    return t1, t2


def tray_walls(params: SimParams):
    """Static tray-wall OBBs: centers (4,3), half extents (4,3), the axis and
    sign that push an escaped sphere back toward the tray center."""
    th, wh, z = params.tray_half, params.tray_wall_height, params.support_z
    centers = [
        (th + 0.02, 0.0, z + wh * 0.5), (-(th + 0.02), 0.0, z + wh * 0.5),
        (0.0, th + 0.02, z + wh * 0.5), (0.0, -(th + 0.02), z + wh * 0.5),
    ]
    he = [
        (0.02, th + 0.04, wh * 0.5), (0.02, th + 0.04, wh * 0.5),
        (th + 0.04, 0.02, wh * 0.5), (th + 0.04, 0.02, wh * 0.5),
    ]
    return centers, he, (0, 0, 1, 1), (-1.0, 1.0, -1.0, 1.0)


def _collect_contacts(state: SimState, params: SimParams):
    """Fixed-size contact arrays (physics.py:162). Slot layout: statics
    (plane, then each tray wall) x K*S, left pad K*S, right pad K*S, then
    object pairs i<j x SC x SC. Per-slot body indices are static."""
    centers, radii, smask = world_spheres(state, params)
    B, K, S = radii.shape
    dev, dt_ = centers.device, centers.dtype
    base, Rg, pads, axes = pad_frames(state.gripper.q)

    flat_c = centers.reshape(B, K * S, 3)
    flat_r = radii.reshape(B, K * S)
    flat_m = smask.reshape(B, K * S)
    flat_ia = torch.arange(K, device=dev).repeat_interleave(S)

    pts, nrms, pens, ias, bkinds, ibs, acts = [], [], [], [], [], [], []
    zeros_i = torch.zeros(K * S, dtype=torch.long, device=dev)

    pen_p = params.support_z - (flat_c[..., 2] - flat_r)
    n_p = torch.zeros_like(flat_c)
    n_p[..., 2] = 1.0
    pts.append(flat_c - flat_r[..., None] * n_p); nrms.append(n_p); pens.append(pen_p)
    ias.append(flat_ia); bkinds.append(zeros_i); ibs.append(zeros_i)
    acts.append(flat_m & (pen_p > 0))

    if params.has_tray:
        eye = torch.eye(3, dtype=dt_, device=dev).expand(B, 3, 3)
        wc, whe, wax, wsg = tray_walls(params)
        for w in range(4):
            bc = torch.tensor(wc[w], dtype=dt_, device=dev).expand(B, 3)
            n_w, pen_w, pt_w, touch_w = _sphere_box_contact(
                flat_c, flat_r, bc, eye, whe[w], wax[w], wsg[w])
            pts.append(pt_w); nrms.append(n_w); pens.append(pen_w)
            ias.append(flat_ia); bkinds.append(zeros_i); ibs.append(zeros_i)
            acts.append(flat_m & touch_w)

    for pad_idx in range(2):
        n_b, pen_b, pt_b, touch = _sphere_box_contact(
            flat_c, flat_r, pads[:, pad_idx], Rg, PAD_HALF_EXTENTS,
            0, 1.0 if pad_idx == 0 else -1.0)
        pts.append(pt_b); nrms.append(n_b); pens.append(pen_b)
        ias.append(flat_ia); bkinds.append(torch.full_like(zeros_i, pad_idx + 1))
        ibs.append(zeros_i); acts.append(flat_m & touch)

    if K > 1:
        obj = state.objects
        Rm = quat_to_matrix(obj.quat)
        oo_local = params.oo_centers[obj.obj_type]
        c2 = obj.pos[:, :, None, :] + torch.einsum("bkij,bksj->bksi", Rm, oo_local)
        r2 = params.oo_radii[obj.obj_type]
        m2 = (r2 > 0.0) & obj.alive[:, :, None]
        SC = r2.shape[2]
        ii, jj = torch.triu_indices(K, K, 1, device=dev)
        P = ii.shape[0]
        ci = c2[:, ii][:, :, :, None, :]
        cj = c2[:, jj][:, :, None, :, :]
        d = ci - cj
        dist = _norm(d)
        rj = r2[:, jj][:, :, None, :]
        rsum = r2[:, ii][:, :, :, None] + rj
        pen_ss = rsum - dist
        n_ss = d / torch.clamp(dist, min=1e-9)[..., None]
        pt_ss = cj + n_ss * (rj + 0.5 * (dist - rsum))[..., None]
        m_ss = m2[:, ii][:, :, :, None] & m2[:, jj][:, :, None, :]
        pts.append(pt_ss.reshape(B, P * SC * SC, 3))
        nrms.append(n_ss.reshape(B, P * SC * SC, 3))
        pens.append(pen_ss.reshape(B, P * SC * SC))
        ias.append(ii.repeat_interleave(SC * SC))
        bkinds.append(torch.full((P * SC * SC,), 3, dtype=torch.long, device=dev))
        ibs.append(jj.repeat_interleave(SC * SC))
        acts.append((m_ss & (pen_ss > 0)).reshape(B, P * SC * SC))

    n_static = K * S * (1 + (4 if params.has_tray else 0))
    n_pad = K * S
    bounds = [0, n_static, n_static + n_pad, n_static + 2 * n_pad]
    bounds.append(sum(a.shape[1] for a in pens))
    return dict(
        point=torch.cat(pts, 1), normal=torch.cat(nrms, 1), pen=torch.cat(pens, 1),
        ia=torch.cat(ias), b_kind=torch.cat(bkinds), ib=torch.cat(ibs),
        active=torch.cat(acts, 1), bounds=tuple(bounds),
    )


def _gripper_jacobian(contacts, base, axes):
    """G (B,N,6,3): per-DOF world velocity at each pad contact point."""
    p = contacts["point"]
    is_l = (contacts["b_kind"] == 1)[None, :, None]
    is_r = (contacts["b_kind"] == 2)[None, :, None]
    pad_mask = (is_l | is_r).to(p.dtype)
    r = p - base[:, None, :]
    zero = torch.zeros_like(p)
    g_x, g_y, g_z = zero.clone(), zero.clone(), zero.clone()
    g_x[..., 0] = 1.0
    g_y[..., 1] = 1.0
    g_z[..., 2] = 1.0
    g_yaw = torch.stack([-r[..., 1], r[..., 0], torch.zeros_like(r[..., 0])], -1)
    g_fl = torch.where(is_l, axes[:, 0][:, None, :], zero)
    g_fr = torch.where(is_r, axes[:, 1][:, None, :], zero)
    return torch.stack(
        [g_x * pad_mask, g_y * pad_mask, g_z * pad_mask, g_yaw * pad_mask, g_fl, g_fr], 2)


def _segment_sum(x, idx, K):
    """Sum x (B,N,...) into K segments along dim 1 by static indices idx (N,)."""
    out = torch.zeros((x.shape[0], K) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    return out.index_add_(1, idx, x)


def _solve_contacts(state, params, contacts, V, W, qd, inv_I_world,
                    warm_lams, motor_plan):
    """Category-sequential projected impulse solver (physics.py:316)."""
    K = V.shape[1]
    n = contacts["normal"]
    p = contacts["point"]
    ia, ib = contacts["ia"], contacts["ib"]
    is_obj_b = contacts["b_kind"] == 3
    objb_f = is_obj_b.to(n.dtype)
    active = contacts["active"]
    actf = active.to(n.dtype)

    base, Rg, pads, axes = pad_frames(state.gripper.q)
    G = _gripper_jacobian(contacts, base, axes)
    t1, t2 = _tangent_basis(n)
    bnds = contacts["bounds"]
    oo_start = bnds[3]

    pos = state.objects.pos
    r_a = p - pos[:, ia]
    r_b = p - pos[:, ib]
    inv_m = params.inv_mass[state.objects.obj_type]
    inv_m_a = inv_m[:, ia]
    inv_m_b = inv_m[:, ib] * objb_f
    iI_a = inv_I_world[:, ia]
    iI_b = inv_I_world[:, ib]
    dof_mass = params.dof("dof_mass")
    inv_dof_mass = 1.0 / dof_mass

    def quad(r, iI, d):
        rxd = _cross(r, d)
        return torch.einsum("bni,bnij,bnj->bn", rxd, iI, rxd)

    def w_dir(d):
        w = inv_m_a + quad(r_a, iI_a, d)
        w = w + (inv_m_b + quad(r_b, iI_b, d)) * objb_f
        Jg = torch.einsum("bngi,bni->bng", G, d)
        w = w + (Jg * Jg * inv_dof_mass).sum(-1)
        return torch.clamp(w, min=1e-9)

    w_n, w_t1, w_t2 = w_dir(n), w_dir(t1), w_dir(t2)
    if params.oo_point_mass_tangent:
        w_pm = torch.clamp(inv_m_a + inv_m_b, min=1e-9)
        w_t1 = torch.where(is_obj_b, w_pm, w_t1)
        w_t2 = torch.where(is_obj_b, w_pm, w_t2)

    bias = torch.clamp(
        params.baumgarte / params.dt * torch.clamp(contacts["pen"] - params.slop, min=0.0),
        max=params.max_bias_velocity)
    mu = params.friction
    omega = params.relaxation

    def rel_vel(V, W, qd, s, e):
        v_a = V[:, ia[s:e]] + _cross(W[:, ia[s:e]], r_a[:, s:e])
        v_b_obj = (V[:, ib[s:e]] + _cross(W[:, ib[s:e]], r_b[:, s:e])) * objb_f[s:e, None]
        v_b_pad = torch.einsum("bngi,bg->bni", G[:, s:e], qd)
        return v_a - v_b_obj - v_b_pad

    def apply_impulse(V, W, qd, P, s, e):
        Pm = P * actf[:, s:e, None]
        dV_a = Pm * inv_m_a[:, s:e, None]
        dW_a = torch.einsum("bnij,bnj->bni", iI_a[:, s:e], _cross(r_a[:, s:e], Pm))
        V = V + _segment_sum(dV_a, ia[s:e], K)
        W = W + _segment_sum(dW_a, ia[s:e], K)
        if s >= oo_start:  # only object-pair rows have a body b
            Pb = Pm * objb_f[s:e, None]
            dV_b = Pb * inv_m_b[:, s:e, None]
            dW_b = torch.einsum("bnij,bnj->bni", iI_b[:, s:e], _cross(r_b[:, s:e], Pb))
            V = V - _segment_sum(dV_b, ib[s:e], K)
            W = W - _segment_sum(dW_b, ib[s:e], K)
        dqd = -torch.einsum("bngi,bni->bng", G[:, s:e], Pm) * inv_dof_mass
        return V, W, qd + dqd.sum(1)

    def friction_update(lam_n, lam_t1, lam_t2, v, s, e, om):
        lt1 = lam_t1 - (v * t1[:, s:e]).sum(-1) / w_t1[:, s:e] * om
        lt2 = lam_t2 - (v * t2[:, s:e]).sum(-1) / w_t2[:, s:e] * om
        t_norm = torch.sqrt(lt1 ** 2 + lt2 ** 2)
        scale = torch.clamp(mu * lam_n / torch.clamp(t_norm, min=1e-9), max=1.0)
        return lt1 * scale, lt2 * scale

    def solve_category(V, W, qd, lam, s, e):
        lam_n, lam_t1, lam_t2 = lam
        v = rel_vel(V, W, qd, s, e)
        v_n = (v * n[:, s:e]).sum(-1)
        dl_n = (bias[:, s:e] - v_n) / w_n[:, s:e] * omega
        lam_n_new = torch.clamp(lam_n + dl_n, min=0.0)
        dl_n = lam_n_new - lam_n
        lt1, lt2 = friction_update(lam_n_new, lam_t1, lam_t2, v, s, e, omega)
        P = (dl_n[..., None] * n[:, s:e] + (lt1 - lam_t1)[..., None] * t1[:, s:e]
             + (lt2 - lam_t2)[..., None] * t2[:, s:e])
        V, W, qd = apply_impulse(V, W, qd, P, s, e)
        return V, W, qd, (lam_n_new, lt1, lt2)

    def solve_friction(V, W, qd, lam, s, e, om):
        lam_n, lam_t1, lam_t2 = lam
        v = rel_vel(V, W, qd, s, e)
        lt1, lt2 = friction_update(lam_n, lam_t1, lam_t2, v, s, e, om)
        P = (lt1 - lam_t1)[..., None] * t1[:, s:e] + (lt2 - lam_t2)[..., None] * t2[:, s:e]
        V, W, qd = apply_impulse(V, W, qd, P, s, e)
        return V, W, qd, (lam_n, lt1, lt2)

    def solve_pads_coupled(V, W, qd, lamL, lamR, sL, eL, sR, eR):
        """Exact 2x2 block solve of the opposing-pad normal rows
        (physics.py:435), mass-split over active spheres per object."""
        nL, nR = n[:, sL:eL], n[:, sR:eR]
        lamLn, lamLt1, lamLt2 = lamL
        lamRn, lamRt1, lamRt2 = lamR
        vL = (rel_vel(V, W, qd, sL, eL) * nL).sum(-1)
        vR = (rel_vel(V, W, qd, sR, eR) * nR).sum(-1)
        rxnL = _cross(r_a[:, sL:eL], nL)
        rxnR = _cross(r_a[:, sR:eR], nR)
        w_obj = inv_m_a[:, sL:eL] * (nL * nR).sum(-1) + torch.einsum(
            "bni,bnij,bnj->bn", rxnL, iI_a[:, sL:eL], rxnR)
        JgL = torch.einsum("bngi,bni->bng", G[:, sL:eL], nL)
        JgR = torch.einsum("bngi,bni->bng", G[:, sR:eR], nR)
        w_dof = (JgL * inv_dof_mass * JgR).sum(-1)
        both = actf[:, sL:eL] * actf[:, sR:eR]
        w_lr = (w_obj + w_dof) * both
        w_ll, w_rr = w_n[:, sL:eL], w_n[:, sR:eR]
        bL = params.pad_bias_scale * bias[:, sL:eL] - vL
        bR = params.pad_bias_scale * bias[:, sR:eR] - vR
        det = torch.maximum(w_ll * w_rr - w_lr * w_lr, 1e-4 * w_ll * w_rr)
        dA_L = (w_rr * bL - w_lr * bR) / det
        dA_R = (w_ll * bR - w_lr * bL) / det
        lamA_L, lamA_R = lamLn + dA_L, lamRn + dA_R
        okA = (lamA_L >= 0.0) & (lamA_R >= 0.0)
        dB_L = -lamLn
        dB_R = (bR - w_lr * dB_L) / w_rr
        lamB_R = lamRn + dB_R
        okB = (lamB_R >= 0.0) & (w_ll * dB_L + w_lr * dB_R - bL >= 0.0)
        dC_R = -lamRn
        dC_L = (bL - w_lr * dC_R) / w_ll
        lamC_L = lamLn + dC_L
        okC = (lamC_L >= 0.0) & (w_lr * dC_L + w_rr * dC_R - bR >= 0.0)
        zero = torch.zeros_like(lamLn)
        newL = torch.where(okA, lamA_L, torch.where(okB, zero, torch.where(okC, lamC_L, zero)))
        newR = torch.where(okA, lamA_R, torch.where(okB, lamB_R, zero))
        iaL, iaR = ia[sL:eL], ia[sR:eR]
        cntL = _segment_sum(actf[:, sL:eL], iaL, K)[:, iaL]
        cntR = _segment_sum(actf[:, sR:eR], iaR, K)[:, iaR]
        newL = lamLn + (newL - lamLn) / torch.clamp(cntL, min=1.0)
        newR = lamRn + (newR - lamRn) / torch.clamp(cntR, min=1.0)
        V, W, qd = apply_impulse(V, W, qd, (newL - lamLn)[..., None] * nL, sL, eL)
        V, W, qd = apply_impulse(V, W, qd, (newR - lamRn)[..., None] * nR, sR, eR)
        V, W, qd, lamL = solve_friction(V, W, qd, (newL, lamLt1, lamLt2), sL, eL, params.pad_omega)
        V, W, qd, lamR = solve_friction(V, W, qd, (newR, lamRt1, lamRt2), sR, eR, params.pad_omega)
        return V, W, qd, lamL, lamR

    cats = [(bnds[i], bnds[i + 1]) for i in range(len(bnds) - 1) if bnds[i + 1] > bnds[i]]
    v_des, motor_cap = motor_plan

    def solve_motor(qd, lam_m):
        lam_new = torch.maximum(torch.minimum(lam_m + (v_des - qd) * dof_mass, motor_cap), -motor_cap)
        return qd + (lam_new - lam_m) / dof_mass, lam_new

    # Warm start: previous substep's impulses, gated by normal continuity.
    if warm_lams is None:
        lams = [tuple(torch.zeros_like(actf[:, s:e]) for _ in range(3)) for s, e in cats]
    else:
        lams = []
        for (s, e), (ln, lt1_, lt2_, n_old) in zip(cats, warm_lams):
            cont = torch.clamp((n_old * n[:, s:e]).sum(-1), 0.0, 1.0) ** 2
            scale = params.warm_start * actf[:, s:e] * cont
            ln, lt1_, lt2_ = ln * scale, lt1_ * scale, lt2_ * scale
            P0 = (ln[..., None] * n[:, s:e] + lt1_[..., None] * t1[:, s:e]
                  + lt2_[..., None] * t2[:, s:e])
            V, W, qd = apply_impulse(V, W, qd, P0, s, e)
            lams.append((ln, lt1_, lt2_))

    lam_m = torch.zeros_like(qd)
    stride = max(int(params.oo_pass_stride), 1)
    for it in range(params.solver_iterations):
        V, W, qd, lams[0] = solve_category(V, W, qd, lams[0], *cats[0])
        for _ in range(params.pad_inner_iterations):
            qd, lam_m = solve_motor(qd, lam_m)
            V, W, qd, lams[1], lams[2] = solve_pads_coupled(
                V, W, qd, lams[1], lams[2], *cats[1], *cats[2])
        if it % stride == 0:
            for ci in range(3, len(cats)):
                V, W, qd, lams[ci] = solve_category(V, W, qd, lams[ci], *cats[ci])

    if params.pinch_damping > 0:
        def touch(ci):
            s, e = cats[ci]
            return _segment_sum(actf[:, s:e], ia[s:e], K) > 0
        pinched = (touch(1) & touch(2))[..., None]
        w_grip = torch.zeros_like(W)
        w_grip[..., 2] = qd[:, 3:4]
        W = torch.where(pinched, W - params.pinch_damping * (W - w_grip), W)

    if params.rolling_damping > 0:
        is_static = ((contacts["b_kind"] == 0)[None] & active).to(n.dtype)
        touch = _segment_sum(is_static, ia, K) > 0
        W = W * torch.where(touch, 1.0 - params.rolling_damping, 1.0)[..., None]

    lams = [lam + (n[:, s:e],) for (s, e), lam in zip(cats, lams)]
    return V, W, qd, lams


def _servo_plan(q, target, finger_target, params):
    """Per-DOF desired velocity and motor impulse cap (physics.py:643)."""
    floor_q2 = params.support_z + PAD_CENTER_DEPTH + PAD_HALF_EXTENTS[2]
    target = target.clone()
    target[:, 2] = torch.clamp(target[:, 2], min=floor_q2)
    full_target = torch.cat([target, finger_target[:, None], finger_target[:, None]], -1)
    err = full_target - q
    dof_mass, dof_force = params.dof("dof_mass"), params.dof("dof_force")
    a_max = dof_force / dof_mass
    g_load = torch.zeros_like(a_max)
    g_load[2] = -params.gravity
    a_brake = torch.clamp(0.8 * a_max - g_load, min=0.5)
    v_stop = torch.sqrt(2.0 * a_brake * torch.abs(err))
    v_des = torch.sign(err) * torch.minimum(
        torch.minimum(torch.abs(err) / params.dt, v_stop), params.dof("dof_vmax"))
    return v_des, dof_force * params.dt


def substep(state: SimState, params: SimParams, warm_lams=None):
    g = state.gripper
    obj = state.objects
    dt = params.dt

    qd = g.qd.clone()
    qd[:, 2] = qd[:, 2] + params.gravity * dt
    motor_plan = _servo_plan(g.q, g.target, g.finger_target, params)

    V = obj.linvel.clone()
    V[..., 2] = V[..., 2] + params.gravity * dt
    V = V * (1.0 - params.lin_damping * dt)
    W = obj.angvel * (1.0 - params.ang_damping * dt)

    R = quat_to_matrix(obj.quat)
    inv_I_world = torch.einsum(
        "bkij,bkj,bklj->bkil", R, params.inv_inertia[obj.obj_type], R)
    contacts = _collect_contacts(state, params)
    V, W, qd, lams = _solve_contacts(
        state, params, contacts, V, W, qd, inv_I_world, warm_lams, motor_plan)

    alive_f = obj.alive[..., None].to(V.dtype)
    V = torch.clamp(V, -4.0, 4.0) * alive_f
    W = torch.clamp(W, -50.0, 50.0) * alive_f
    pos = obj.pos + V * dt
    qv, qw = obj.quat[..., :3], obj.quat[..., 3:4]
    dquat = torch.cat([qw * W + _cross(W, qv), -(W * qv).sum(-1, keepdim=True)], -1)
    quat = obj.quat + 0.5 * dt * dquat
    quat = quat / torch.clamp(_norm(quat, keepdim=True), min=1e-9)

    q = g.q + qd * dt
    f = torch.clamp(q[:, 4:6], FINGER_LIMIT_LOW, FINGER_LIMIT_HIGH)
    qd = qd.clone()
    qd[:, 4:6] = torch.where(f != q[:, 4:6], torch.zeros_like(f), qd[:, 4:6])
    q = q.clone()
    q[:, 4:6] = f
    floor_q2 = params.support_z + PAD_CENTER_DEPTH + PAD_HALF_EXTENTS[2]
    hit_floor = q[:, 2] < floor_q2
    q[:, 2] = torch.clamp(q[:, 2], min=floor_q2)
    qd[:, 2] = torch.where(hit_floor, torch.clamp(qd[:, 2], min=0.0), qd[:, 2])

    new_state = SimState(
        gripper=GripperState(
            q=q, qd=qd, target=g.target, finger_target=g.finger_target,
            gripper_close=g.gripper_close, ee_angle=g.ee_angle),
        objects=ObjectState(
            pos=pos, quat=quat, linvel=V, angvel=W,
            obj_type=obj.obj_type, alive=obj.alive),
    )
    return new_state, lams


def run(state: SimState, params: SimParams, n_substeps: int) -> SimState:
    """Advance every env `n_substeps` x dt, warm-starting contact impulses
    across the substeps of the run (physics.py:741)."""
    lams = None
    for _ in range(n_substeps):
        state, lams = substep(state, params, lams)
    return state


def gripper_width(q):
    """Opening width, reference formula (robot.py:279-284)."""
    return (FINGER_CLOSED_WIDTH - q[..., 4]) + (FINGER_CLOSED_WIDTH - q[..., 5])
