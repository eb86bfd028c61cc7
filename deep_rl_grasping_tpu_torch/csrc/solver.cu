// Contact-solver substep loop for the flying-gripper grasp world, one CUDA
// thread per env.
//
// Replaces the Pallas TPU kernel deep_rl_grasping_tpu/ops/solver_pallas.py
// (_make_kernel :107, called from run_batch :1037 / run_batched_sim :1126).
// It computes what sim/physics.py `run` computes, and what the port's plain
// version deep_rl_grasping_tpu_torch/sim/physics.py computes: `n_substeps`
// substeps, each with contact generation (spheres vs support plane, tray
// walls and finger pads; coarse object spheres vs each other), a warm start
// gated by normal continuity, `solver_iterations` rounds of
// [statics; pad_inner x (motor rows, coupled 2x2 pad rows, pad friction);
// object-object every `oo_pass_stride` rounds], rolling and pinch damping,
// and integration with finger limits and the fingertip floor stop. Within a
// category the rows are relaxed Jacobi, as in the plain version.
//
// Design. The TPU kernel puts envs on the 128-wide lane axis and holds the
// whole contact working set in VMEM (up to 100 MB per 128-env block). On
// Hopper one thread owns one env: its state and contact rows live in
// registers and thread-local memory (a 58 KB stack frame sized for the
// largest shapes, which L1/L2 keep resident), the whole substep loop runs in one
// launch, and there is no shared memory and no barrier. Every loop has a
// trip count fixed by the launch arguments; there is no convergence loop.
//
// What bounds it on the H100: neither bytes nor FLOPs. The inputs and
// outputs are ~2 KB per env; the work is ~6 x 10^6 dependent float operations
// per env per control step, serial within a thread, and at B=100 envs only
// 4 warps run, on 4 of the 132 SMs. The kernel is latency-bound; spreading
// one env's contact rows over a warp is the obvious next step.

#include <cuda_runtime.h>

#define MAXK 6
#define MAXS 8
#define MAXSC 4
#define MAXNS 5
#define MAXP ((MAXK * (MAXK - 1)) / 2)
#define MAX_ST (MAXNS * MAXK * MAXS)
#define MAX_PD (MAXK * MAXS)
#define MAX_OO (MAXP * MAXSC * MAXSC)

struct SolverParams {
  float dt, support_z, tray_half, tray_wall_height, friction, baumgarte, slop,
      relaxation, gravity, lin_damping, ang_damping, max_bias_velocity,
      warm_start, pad_omega, pad_bias_scale, rolling_damping, pinch_damping;
  float dof_mass[6], dof_force[6], dof_vmax[6];
  int B, K, S, SC, n_substeps, solver_iterations, pad_inner, oo_stride,
      has_tray, oo_pm_tangent;
};

// Geometry constants (sim/types.py).
#define FINGER_LIMIT_LOW (-0.01f)
#define FINGER_LIMIT_HIGH 0.05f
#define PAD_X_OFFSET 0.062f
#define PAD_HX 0.010f
#define PAD_HY 0.010f
#define PAD_HZ 0.075f
#define PAD_CENTER_DEPTH 0.187f

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 mk(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scl(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float sgnf(float x) { return (float)((x > 0.f) - (x < 0.f)); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// Symmetric world inverse inertia (xx, yy, zz, xy, xz, yz).
struct Sym {
  float xx, yy, zz, xy, xz, yz;
};
__device__ __forceinline__ V3 sym_apply(const Sym& m, V3 v) {
  return {m.xx * v.x + m.xy * v.y + m.xz * v.z, m.xy * v.x + m.yy * v.y + m.yz * v.z,
          m.xz * v.x + m.yz * v.y + m.zz * v.z};
}
__device__ __forceinline__ float sym_quad(const Sym& m, V3 v) { return dot(v, sym_apply(m, v)); }

__device__ __forceinline__ void tangent_basis(V3 n, V3& t1, V3& t2) {
  V3 a = fabsf(n.x) < 0.9f ? mk(1.f, 0.f, 0.f) : mk(0.f, 1.f, 0.f);
  t1 = cross(n, a);
  float l = sqrtf(dot(t1, t1));
  t1 = scl(t1, 1.f / fmaxf(l, 1e-9f));
  t2 = cross(n, t1);
}

// Sphere vs OBB with a fixed inside-recovery axis and sign (physics.py:113).
// The box frame has columns (ax, ay, az).
__device__ __forceinline__ void sphere_box(V3 c, float r, V3 bc, V3 ax, V3 ay, V3 az,
                                           V3 he, int in_axis, float in_sign, V3& n,
                                           float& pen) {
  V3 d = sub(c, bc);
  float l[3] = {dot(ax, d), dot(ay, d), dot(az, d)};
  float h[3] = {he.x, he.y, he.z};
  float dl[3];
  for (int i = 0; i < 3; ++i) dl[i] = l[i] - clampf(l[i], -h[i], h[i]);
  float dist = sqrtf(dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]);
  bool outside = dist > 1e-9f;
  float nl[3];
  float inv = 1.f / fmaxf(dist, 1e-9f);
  for (int i = 0; i < 3; ++i)
    nl[i] = outside ? dl[i] * inv : (i == in_axis ? in_sign : 0.f);
  pen = outside ? r - dist : r + h[in_axis] - in_sign * l[in_axis];
  n = add(add(scl(ax, nl[0]), scl(ay, nl[1])), scl(az, nl[2]));
}

// One contact row: geometry, solve constants and impulses.
struct Row {
  V3 n, t1, t2, r;  // r: contact point relative to body a's COM
  float wn, wt1, wt2, bias, act;
};

// Gripper-side jacobian of a pad row along d: DOFs (x, y, z, yaw, finger).
__device__ __forceinline__ void pad_jac(V3 d, float rbx, float rby, V3 axis, float j[5]) {
  j[0] = d.x;
  j[1] = d.y;
  j[2] = d.z;
  j[3] = -rby * d.x + rbx * d.y;
  j[4] = dot(axis, d);
}

__global__ void solver_kernel(SolverParams sp, const float* __restrict__ gq,
                              const float* __restrict__ gqd, const float* __restrict__ gtarget,
                              const float* __restrict__ gftgt, const float* __restrict__ opos,
                              const float* __restrict__ oquat, const float* __restrict__ olin,
                              const float* __restrict__ oang, const float* __restrict__ oalive,
                              const float* __restrict__ lcent, const float* __restrict__ lrad,
                              const float* __restrict__ lcent2, const float* __restrict__ lrad2,
                              const float* __restrict__ linvm, const float* __restrict__ linvI,
                              float* __restrict__ q_out, float* __restrict__ qd_out,
                              float* __restrict__ pos_out, float* __restrict__ quat_out,
                              float* __restrict__ lin_out, float* __restrict__ ang_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < sp.B) {  // padded threads do nothing; there is no barrier anywhere
    const int K = sp.K, S = sp.S, SC = sp.SC;
    const int NS = sp.has_tray ? 5 : 1;
    const int KS = K * S;
    const int NP = (K * (K - 1)) / 2;
    const int NOO = NP * SC * SC;
    const float dt = sp.dt;
    const float mu = sp.friction, omega = sp.relaxation;
    const float floor_q2 = sp.support_z + PAD_CENTER_DEPTH + PAD_HZ;
    const float bias_coef = sp.baumgarte / dt;

    float q[6], qd[6], tgt[4];
    for (int d = 0; d < 6; ++d) {
      q[d] = gq[e * 6 + d];
      qd[d] = gqd[e * 6 + d];
    }
    for (int d = 0; d < 4; ++d) tgt[d] = gtarget[e * 4 + d];
    const float ftgt = gftgt[e];

    V3 pos[MAXK], V[MAXK], W[MAXK];
    float quat[MAXK][4], alive[MAXK], invm[MAXK], invI[MAXK][3];
    for (int k = 0; k < K; ++k) {
      const int o = e * K + k;
      pos[k] = mk(opos[o * 3], opos[o * 3 + 1], opos[o * 3 + 2]);
      V[k] = mk(olin[o * 3], olin[o * 3 + 1], olin[o * 3 + 2]);
      W[k] = mk(oang[o * 3], oang[o * 3 + 1], oang[o * 3 + 2]);
      for (int c = 0; c < 4; ++c) quat[k][c] = oquat[o * 4 + c];
      alive[k] = oalive[o];
      invm[k] = linvm[o];
      for (int c = 0; c < 3; ++c) invI[k][c] = linvI[o * 3 + c];
    }

    // Servo plan constants (physics.py:643).
    float a_brake[6];
    for (int d = 0; d < 6; ++d) {
      float a_max = sp.dof_force[d] / sp.dof_mass[d];
      float g_load = d == 2 ? -sp.gravity : 0.f;
      a_brake[d] = fmaxf(0.8f * a_max - g_load, 0.5f);
    }

    // Tray walls (static OBBs, world-axis aligned).
    const float th = sp.tray_half, wh = sp.tray_wall_height;
    const V3 wall_c[4] = {mk(th + 0.02f, 0.f, sp.support_z + wh * 0.5f),
                          mk(-(th + 0.02f), 0.f, sp.support_z + wh * 0.5f),
                          mk(0.f, th + 0.02f, sp.support_z + wh * 0.5f),
                          mk(0.f, -(th + 0.02f), sp.support_z + wh * 0.5f)};
    const V3 wall_he[4] = {mk(0.02f, th + 0.04f, wh * 0.5f), mk(0.02f, th + 0.04f, wh * 0.5f),
                           mk(th + 0.04f, 0.02f, wh * 0.5f), mk(th + 0.04f, 0.02f, wh * 0.5f)};
    const int wall_ax[4] = {0, 0, 1, 1};
    const float wall_sg[4] = {-1.f, 1.f, -1.f, 1.f};

    // Rows and warm-start memory (impulses and normals of the last substep).
    Row st[MAX_ST], pl[MAX_PD], pr[MAX_PD], oo[MAX_OO];
    float lst[MAX_ST][3], lpl[MAX_PD][3], lpr[MAX_PD][3], loo[MAX_OO][3];
    V3 nst[MAX_ST], npl[MAX_PD], npr[MAX_PD], noo[MAX_OO];
    float plrb[MAX_PD][2], prrb[MAX_PD][2];  // pad point minus gripper base (x, y)
    V3 oorb[MAX_OO];                         // pair point minus body b's COM
    float padwlr[MAX_PD];
    float cntL[MAXK], cntR[MAXK];
    int pi_[MAXP], pj_[MAXP];
    {
      int p = 0;
      for (int i = 0; i < K; ++i)
        for (int j = i + 1; j < K; ++j) {
          pi_[p] = i;
          pj_[p] = j;
          ++p;
        }
    }

#pragma unroll 1
    for (int step = 0; step < sp.n_substeps; ++step) {
      const bool first = step == 0;
      // ---- 1. free-velocity update + servo plan
      qd[2] += sp.gravity * dt;
      float full_t[6] = {tgt[0], tgt[1], fmaxf(tgt[2], floor_q2), tgt[3], ftgt, ftgt};
      float v_des[6], cap[6];
      for (int d = 0; d < 6; ++d) {
        float err = full_t[d] - q[d];
        float v_stop = sqrtf(2.f * a_brake[d] * fabsf(err));
        v_des[d] = sgnf(err) * fminf(fminf(fabsf(err) / dt, v_stop), sp.dof_vmax[d]);
        cap[d] = sp.dof_force[d] * dt;
      }
      const float ld = 1.f - sp.lin_damping * dt, ad = 1.f - sp.ang_damping * dt;
      for (int k = 0; k < K; ++k) {
        V[k] = mk(V[k].x * ld, V[k].y * ld, (V[k].z + sp.gravity * dt) * ld);
        W[k] = scl(W[k], ad);
      }

      // ---- 2. rotations and world inverse inertia
      float R[MAXK][3][3];
      Sym iI[MAXK];
      for (int k = 0; k < K; ++k) {
        float x = quat[k][0], y = quat[k][1], z = quat[k][2], w = quat[k][3];
        R[k][0][0] = 1 - 2 * (y * y + z * z);
        R[k][0][1] = 2 * (x * y - w * z);
        R[k][0][2] = 2 * (x * z + w * y);
        R[k][1][0] = 2 * (x * y + w * z);
        R[k][1][1] = 1 - 2 * (x * x + z * z);
        R[k][1][2] = 2 * (y * z - w * x);
        R[k][2][0] = 2 * (x * z - w * y);
        R[k][2][1] = 2 * (y * z + w * x);
        R[k][2][2] = 1 - 2 * (x * x + y * y);
        float m[3][3];
        for (int i = 0; i < 3; ++i)
          for (int l = 0; l < 3; ++l)
            m[i][l] = R[k][i][0] * invI[k][0] * R[k][l][0] + R[k][i][1] * invI[k][1] * R[k][l][1] +
                      R[k][i][2] * invI[k][2] * R[k][l][2];
        iI[k] = {m[0][0], m[1][1], m[2][2], m[0][1], m[0][2], m[1][2]};
      }

      // ---- 3. gripper frame
      const float cyw = cosf(q[3]), syw = sinf(q[3]);
      const V3 ex = mk(cyw, syw, 0.f), ey = mk(-syw, cyw, 0.f), ez = mk(0.f, 0.f, 1.f);
      const V3 base = mk(q[0], q[1], q[2]);
      const V3 c_l = mk(q[0] - ex.x * (PAD_X_OFFSET - q[4]), q[1] - ex.y * (PAD_X_OFFSET - q[4]),
                        q[2] - PAD_CENTER_DEPTH);
      const V3 c_r = mk(q[0] + ex.x * (PAD_X_OFFSET - q[5]), q[1] + ex.y * (PAD_X_OFFSET - q[5]),
                        q[2] - PAD_CENTER_DEPTH);
      const V3 axis_l = ex, axis_r = scl(ex, -1.f);
      const float idm[6] = {1.f / sp.dof_mass[0], 1.f / sp.dof_mass[1], 1.f / sp.dof_mass[2],
                            1.f / sp.dof_mass[3], 1.f / sp.dof_mass[4], 1.f / sp.dof_mass[5]};

      // ---- 4. contacts and solve constants
      for (int k = 0; k < K; ++k) {
        cntL[k] = 0.f;
        cntR[k] = 0.f;
      }
      for (int k = 0; k < K; ++k) {
        const int o = e * K + k;
        for (int s = 0; s < S; ++s) {
          const float rad = lrad[o * S + s];
          const float* lc = lcent + (o * S + s) * 3;
          V3 cw = mk(pos[k].x + R[k][0][0] * lc[0] + R[k][0][1] * lc[1] + R[k][0][2] * lc[2],
                     pos[k].y + R[k][1][0] * lc[0] + R[k][1][1] * lc[1] + R[k][1][2] * lc[2],
                     pos[k].z + R[k][2][0] * lc[0] + R[k][2][1] * lc[1] + R[k][2][2] * lc[2]);
          const bool smask = rad > 0.f && alive[k] > 0.5f;
          const int slot = k * S + s;
          // statics: plane, then walls
          for (int w = 0; w < NS; ++w) {
            V3 n;
            float pen;
            if (w == 0) {
              n = ez;
              pen = sp.support_z - (cw.z - rad);
            } else {
              sphere_box(cw, rad, wall_c[w - 1], mk(1.f, 0.f, 0.f), mk(0.f, 1.f, 0.f), ez,
                         wall_he[w - 1], wall_ax[w - 1], wall_sg[w - 1], n, pen);
            }
            Row& rw = st[w * KS + slot];
            rw.n = n;
            rw.r = sub(sub(cw, scl(n, rad)), pos[k]);
            rw.act = (smask && pen > 0.f) ? 1.f : 0.f;
            rw.bias = fminf(bias_coef * fmaxf(pen - sp.slop, 0.f), sp.max_bias_velocity);
            tangent_basis(n, rw.t1, rw.t2);
            rw.wn = fmaxf(invm[k] + sym_quad(iI[k], cross(rw.r, rw.n)), 1e-9f);
            rw.wt1 = fmaxf(invm[k] + sym_quad(iI[k], cross(rw.r, rw.t1)), 1e-9f);
            rw.wt2 = fmaxf(invm[k] + sym_quad(iI[k], cross(rw.r, rw.t2)), 1e-9f);
          }
          // finger pads
          for (int side = 0; side < 2; ++side) {
            V3 n;
            float pen;
            sphere_box(cw, rad, side == 0 ? c_l : c_r, ex, ey, ez, mk(PAD_HX, PAD_HY, PAD_HZ), 0,
                       side == 0 ? 1.f : -1.f, n, pen);
            Row& rw = side == 0 ? pl[slot] : pr[slot];
            float* rb = side == 0 ? plrb[slot] : prrb[slot];
            const V3 axis = side == 0 ? axis_l : axis_r;
            const V3 pt = sub(cw, scl(n, rad));
            rw.n = n;
            rw.r = sub(pt, pos[k]);
            rb[0] = pt.x - base.x;
            rb[1] = pt.y - base.y;
            rw.act = (smask && pen > 0.f) ? 1.f : 0.f;
            rw.bias = fminf(bias_coef * fmaxf(pen - sp.slop, 0.f), sp.max_bias_velocity);
            tangent_basis(n, rw.t1, rw.t2);
            const int fd = side == 0 ? 4 : 5;
            float j[5];
            V3 dirs[3] = {rw.n, rw.t1, rw.t2};
            float ws[3];
            for (int di = 0; di < 3; ++di) {
              pad_jac(dirs[di], rb[0], rb[1], axis, j);
              ws[di] = fmaxf(invm[k] + sym_quad(iI[k], cross(rw.r, dirs[di])) +
                                 j[0] * j[0] * idm[0] + j[1] * j[1] * idm[1] +
                                 j[2] * j[2] * idm[2] + j[3] * j[3] * idm[3] +
                                 j[4] * j[4] * idm[fd],
                             1e-9f);
            }
            rw.wn = ws[0];
            rw.wt1 = ws[1];
            rw.wt2 = ws[2];
            if (side == 0)
              cntL[k] += rw.act;
            else
              cntR[k] += rw.act;
          }
        }
      }
      // cross effective mass of the aligned left/right pad normal rows
      for (int slot = 0; slot < KS; ++slot) {
        const int k = slot / S;
        const Row& L = pl[slot];
        const Row& Rr = pr[slot];
        float jl[5], jr[5];
        pad_jac(L.n, plrb[slot][0], plrb[slot][1], axis_l, jl);
        pad_jac(Rr.n, prrb[slot][0], prrb[slot][1], axis_r, jr);
        float w_obj = invm[k] * dot(L.n, Rr.n) + dot(cross(L.r, L.n), sym_apply(iI[k], cross(Rr.r, Rr.n)));
        float w_dof = jl[0] * idm[0] * jr[0] + jl[1] * idm[1] * jr[1] + jl[2] * idm[2] * jr[2] +
                      jl[3] * idm[3] * jr[3];
        padwlr[slot] = (w_obj + w_dof) * (L.act * Rr.act);
      }
      // object pairs (coarse spheres)
      for (int p = 0; p < NP; ++p) {
        const int i = pi_[p], j = pj_[p];
        const int oi = e * K + i, oj = e * K + j;
        for (int a = 0; a < SC; ++a) {
          const float* la = lcent2 + (oi * SC + a) * 3;
          const float ra = lrad2[oi * SC + a];
          V3 ca = mk(pos[i].x + R[i][0][0] * la[0] + R[i][0][1] * la[1] + R[i][0][2] * la[2],
                     pos[i].y + R[i][1][0] * la[0] + R[i][1][1] * la[1] + R[i][1][2] * la[2],
                     pos[i].z + R[i][2][0] * la[0] + R[i][2][1] * la[1] + R[i][2][2] * la[2]);
          for (int b = 0; b < SC; ++b) {
            const float* lb = lcent2 + (oj * SC + b) * 3;
            const float rbd = lrad2[oj * SC + b];
            V3 cb = mk(pos[j].x + R[j][0][0] * lb[0] + R[j][0][1] * lb[1] + R[j][0][2] * lb[2],
                       pos[j].y + R[j][1][0] * lb[0] + R[j][1][1] * lb[1] + R[j][1][2] * lb[2],
                       pos[j].z + R[j][2][0] * lb[0] + R[j][2][1] * lb[1] + R[j][2][2] * lb[2]);
            V3 d = sub(ca, cb);
            float dist = sqrtf(dot(d, d));
            float rsum = ra + rbd;
            float pen = rsum - dist;
            V3 n = scl(d, 1.f / fmaxf(dist, 1e-9f));
            V3 pt = add(cb, scl(n, rbd + 0.5f * (dist - rsum)));
            const bool m = ra > 0.f && rbd > 0.f && alive[i] > 0.5f && alive[j] > 0.5f;
            const int slot = (p * SC + a) * SC + b;
            Row& rw = oo[slot];
            rw.n = n;
            rw.r = sub(pt, pos[i]);
            oorb[slot] = sub(pt, pos[j]);
            rw.act = (m && pen > 0.f) ? 1.f : 0.f;
            rw.bias = fminf(bias_coef * fmaxf(pen - sp.slop, 0.f), sp.max_bias_velocity);
            tangent_basis(n, rw.t1, rw.t2);
            rw.wn = fmaxf(invm[i] + sym_quad(iI[i], cross(rw.r, n)) + invm[j] +
                              sym_quad(iI[j], cross(oorb[slot], n)),
                          1e-9f);
            if (sp.oo_pm_tangent) {
              rw.wt1 = rw.wt2 = fmaxf(invm[i] + invm[j], 1e-9f);
            } else {
              rw.wt1 = fmaxf(invm[i] + sym_quad(iI[i], cross(rw.r, rw.t1)) + invm[j] +
                                 sym_quad(iI[j], cross(oorb[slot], rw.t1)),
                             1e-9f);
              rw.wt2 = fmaxf(invm[i] + sym_quad(iI[i], cross(rw.r, rw.t2)) + invm[j] +
                                 sym_quad(iI[j], cross(oorb[slot], rw.t2)),
                             1e-9f);
            }
          }
        }
      }

      // ---- 5. warm start, gated by normal continuity (physics.py:568-585)
      V3 dV[MAXK], dW[MAXK];
      float dqd[6];
      for (int k = 0; k < K; ++k) dV[k] = dW[k] = mk(0.f, 0.f, 0.f);
      for (int d = 0; d < 6; ++d) dqd[d] = 0.f;
      const float ws = first ? 0.f : sp.warm_start;
      for (int c = 0; c < NS * KS; ++c) {
        const Row& rw = st[c];
        float cont = first ? 0.f : clampf(dot(nst[c], rw.n), 0.f, 1.f);
        float g = ws * rw.act * cont * cont;
        for (int l = 0; l < 3; ++l) lst[c][l] = first ? 0.f : lst[c][l] * g;
        V3 P = scl(add(add(scl(rw.n, lst[c][0]), scl(rw.t1, lst[c][1])), scl(rw.t2, lst[c][2])), rw.act);
        const int k = (c % KS) / S;
        dV[k] = add(dV[k], scl(P, invm[k]));
        dW[k] = add(dW[k], sym_apply(iI[k], cross(rw.r, P)));
      }
      for (int side = 0; side < 2; ++side) {
        for (int c = 0; c < KS; ++c) {
          const Row& rw = side == 0 ? pl[c] : pr[c];
          float* lam = side == 0 ? lpl[c] : lpr[c];
          const V3 nold = side == 0 ? npl[c] : npr[c];
          const float* rb = side == 0 ? plrb[c] : prrb[c];
          float cont = first ? 0.f : clampf(dot(nold, rw.n), 0.f, 1.f);
          float g = ws * rw.act * cont * cont;
          for (int l = 0; l < 3; ++l) lam[l] = first ? 0.f : lam[l] * g;
          V3 P = scl(add(add(scl(rw.n, lam[0]), scl(rw.t1, lam[1])), scl(rw.t2, lam[2])), rw.act);
          const int k = c / S;
          dV[k] = add(dV[k], scl(P, invm[k]));
          dW[k] = add(dW[k], sym_apply(iI[k], cross(rw.r, P)));
          float j[5];
          pad_jac(P, rb[0], rb[1], side == 0 ? axis_l : axis_r, j);
          for (int d = 0; d < 4; ++d) dqd[d] -= j[d] * idm[d];
          dqd[4 + side] -= j[4] * idm[4 + side];
        }
      }
      for (int c = 0; c < NOO; ++c) {
        const Row& rw = oo[c];
        float cont = first ? 0.f : clampf(dot(noo[c], rw.n), 0.f, 1.f);
        float g = ws * rw.act * cont * cont;
        for (int l = 0; l < 3; ++l) loo[c][l] = first ? 0.f : loo[c][l] * g;
        V3 P = scl(add(add(scl(rw.n, loo[c][0]), scl(rw.t1, loo[c][1])), scl(rw.t2, loo[c][2])), rw.act);
        const int p = c / (SC * SC);
        const int i = pi_[p], j = pj_[p];
        dV[i] = add(dV[i], scl(P, invm[i]));
        dW[i] = add(dW[i], sym_apply(iI[i], cross(rw.r, P)));
        dV[j] = sub(dV[j], scl(P, invm[j]));
        dW[j] = sub(dW[j], sym_apply(iI[j], cross(oorb[c], P)));
      }
      for (int k = 0; k < K; ++k) {
        V[k] = add(V[k], dV[k]);
        W[k] = add(W[k], dW[k]);
      }
      for (int d = 0; d < 6; ++d) qd[d] += dqd[d];

      // ---- 6. solver iterations
      float lam_m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
      for (int it = 0; it < sp.solver_iterations; ++it) {
        // statics (Jacobi within the category)
        for (int k = 0; k < K; ++k) dV[k] = dW[k] = mk(0.f, 0.f, 0.f);
        for (int c = 0; c < NS * KS; ++c) {
          const Row& rw = st[c];
          const int k = (c % KS) / S;
          V3 v = add(V[k], cross(W[k], rw.r));
          float dl_n = (rw.bias - dot(v, rw.n)) / rw.wn * omega;
          float ln = fmaxf(lst[c][0] + dl_n, 0.f);
          dl_n = ln - lst[c][0];
          float lt1 = lst[c][1] - dot(v, rw.t1) / rw.wt1 * omega;
          float lt2 = lst[c][2] - dot(v, rw.t2) / rw.wt2 * omega;
          float tn = sqrtf(lt1 * lt1 + lt2 * lt2);
          float sc = fminf(1.f, mu * ln / fmaxf(tn, 1e-9f));
          lt1 *= sc;
          lt2 *= sc;
          V3 P = add(add(scl(rw.n, dl_n), scl(rw.t1, lt1 - lst[c][1])), scl(rw.t2, lt2 - lst[c][2]));
          P = scl(P, rw.act);
          lst[c][0] = ln;
          lst[c][1] = lt1;
          lst[c][2] = lt2;
          dV[k] = add(dV[k], scl(P, invm[k]));
          dW[k] = add(dW[k], sym_apply(iI[k], cross(rw.r, P)));
        }
        for (int k = 0; k < K; ++k) {
          V[k] = add(V[k], dV[k]);
          W[k] = add(W[k], dW[k]);
        }

#pragma unroll 1
        for (int pass = 0; pass < sp.pad_inner; ++pass) {
          // motor rows: exact 1-D clamped projection per DOF
          for (int d = 0; d < 6; ++d) {
            float ln = clampf(lam_m[d] + (v_des[d] - qd[d]) * sp.dof_mass[d], -cap[d], cap[d]);
            qd[d] += (ln - lam_m[d]) / sp.dof_mass[d];
            lam_m[d] = ln;
          }
          // coupled 2x2 normal solve of the opposing pads (physics.py:435)
          for (int k = 0; k < K; ++k) dV[k] = dW[k] = mk(0.f, 0.f, 0.f);
          for (int d = 0; d < 6; ++d) dqd[d] = 0.f;
          for (int c = 0; c < KS; ++c) {
            const int k = c / S;
            const Row& L = pl[c];
            const Row& Rr = pr[c];
            float jl[5], jr[5];
            pad_jac(L.n, plrb[c][0], plrb[c][1], axis_l, jl);
            pad_jac(Rr.n, prrb[c][0], prrb[c][1], axis_r, jr);
            float vL = dot(add(V[k], cross(W[k], L.r)), L.n) -
                       (jl[0] * qd[0] + jl[1] * qd[1] + jl[2] * qd[2] + jl[3] * qd[3] + jl[4] * qd[4]);
            float vR = dot(add(V[k], cross(W[k], Rr.r)), Rr.n) -
                       (jr[0] * qd[0] + jr[1] * qd[1] + jr[2] * qd[2] + jr[3] * qd[3] + jr[4] * qd[5]);
            const float w_ll = L.wn, w_rr = Rr.wn, w_lr = padwlr[c];
            const float bL = sp.pad_bias_scale * L.bias - vL;
            const float bR = sp.pad_bias_scale * Rr.bias - vR;
            const float det = fmaxf(w_ll * w_rr - w_lr * w_lr, 1e-4f * w_ll * w_rr);
            const float lLn = lpl[c][0], lRn = lpr[c][0];
            const float dA_L = (w_rr * bL - w_lr * bR) / det;
            const float dA_R = (w_ll * bR - w_lr * bL) / det;
            const float lamA_L = lLn + dA_L, lamA_R = lRn + dA_R;
            const bool okA = lamA_L >= 0.f && lamA_R >= 0.f;
            const float dB_L = -lLn;
            const float dB_R = (bR - w_lr * dB_L) / w_rr;
            const float lamB_R = lRn + dB_R;
            const bool okB = lamB_R >= 0.f && (w_ll * dB_L + w_lr * dB_R - bL >= 0.f);
            const float dC_R = -lRn;
            const float dC_L = (bL - w_lr * dC_R) / w_ll;
            const float lamC_L = lLn + dC_L;
            const bool okC = lamC_L >= 0.f && (w_lr * dC_L + w_rr * dC_R - bR >= 0.f);
            float newL = okA ? lamA_L : (okB ? 0.f : (okC ? lamC_L : 0.f));
            float newR = okA ? lamA_R : (okB ? lamB_R : 0.f);
            newL = lLn + (newL - lLn) / fmaxf(cntL[k], 1.f);
            newR = lRn + (newR - lRn) / fmaxf(cntR[k], 1.f);
            lpl[c][0] = newL;
            lpr[c][0] = newR;
            const V3 PL = scl(L.n, (newL - lLn) * L.act);
            const V3 PR = scl(Rr.n, (newR - lRn) * Rr.act);
            dV[k] = add(dV[k], scl(add(PL, PR), invm[k]));
            dW[k] = add(dW[k], sym_apply(iI[k], add(cross(L.r, PL), cross(Rr.r, PR))));
            float gl[5], gr[5];
            pad_jac(PL, plrb[c][0], plrb[c][1], axis_l, gl);
            pad_jac(PR, prrb[c][0], prrb[c][1], axis_r, gr);
            for (int d = 0; d < 4; ++d) dqd[d] -= (gl[d] + gr[d]) * idm[d];
            dqd[4] -= gl[4] * idm[4];
            dqd[5] -= gr[4] * idm[5];
          }
          for (int k = 0; k < K; ++k) {
            V[k] = add(V[k], dV[k]);
            W[k] = add(W[k], dW[k]);
          }
          for (int d = 0; d < 6; ++d) qd[d] += dqd[d];
          // pad friction: left, then right (physics.py:505-510)
          for (int side = 0; side < 2; ++side) {
            for (int k = 0; k < K; ++k) dV[k] = dW[k] = mk(0.f, 0.f, 0.f);
            for (int d = 0; d < 6; ++d) dqd[d] = 0.f;
            const V3 axis = side == 0 ? axis_l : axis_r;
            const int fd = side == 0 ? 4 : 5;
            for (int c = 0; c < KS; ++c) {
              const int k = c / S;
              const Row& rw = side == 0 ? pl[c] : pr[c];
              float* lam = side == 0 ? lpl[c] : lpr[c];
              const float* rb = side == 0 ? plrb[c] : prrb[c];
              float j1[5], j2[5];
              pad_jac(rw.t1, rb[0], rb[1], axis, j1);
              pad_jac(rw.t2, rb[0], rb[1], axis, j2);
              V3 v = add(V[k], cross(W[k], rw.r));
              float vt1 = dot(v, rw.t1) -
                          (j1[0] * qd[0] + j1[1] * qd[1] + j1[2] * qd[2] + j1[3] * qd[3] + j1[4] * qd[fd]);
              float vt2 = dot(v, rw.t2) -
                          (j2[0] * qd[0] + j2[1] * qd[1] + j2[2] * qd[2] + j2[3] * qd[3] + j2[4] * qd[fd]);
              float lt1 = lam[1] - vt1 / rw.wt1 * sp.pad_omega;
              float lt2 = lam[2] - vt2 / rw.wt2 * sp.pad_omega;
              float tn = sqrtf(lt1 * lt1 + lt2 * lt2);
              float sc = fminf(1.f, mu * lam[0] / fmaxf(tn, 1e-9f));
              lt1 *= sc;
              lt2 *= sc;
              const float d1 = (lt1 - lam[1]) * rw.act, d2 = (lt2 - lam[2]) * rw.act;
              lam[1] = lt1;
              lam[2] = lt2;
              V3 P = add(scl(rw.t1, d1), scl(rw.t2, d2));
              dV[k] = add(dV[k], scl(P, invm[k]));
              dW[k] = add(dW[k], sym_apply(iI[k], cross(rw.r, P)));
              float gj[5];
              pad_jac(P, rb[0], rb[1], axis, gj);
              for (int d = 0; d < 4; ++d) dqd[d] -= gj[d] * idm[d];
              dqd[fd] -= gj[4] * idm[fd];
            }
            for (int k = 0; k < K; ++k) {
              V[k] = add(V[k], dV[k]);
              W[k] = add(W[k], dW[k]);
            }
            for (int d = 0; d < 6; ++d) qd[d] += dqd[d];
          }
        }

        // object-object rows every oo_stride iterations (always on the first)
        if (it % sp.oo_stride == 0) {
          for (int k = 0; k < K; ++k) dV[k] = dW[k] = mk(0.f, 0.f, 0.f);
          for (int c = 0; c < NOO; ++c) {
            const Row& rw = oo[c];
            const int p = c / (SC * SC);
            const int i = pi_[p], j = pj_[p];
            V3 v = sub(add(V[i], cross(W[i], rw.r)), add(V[j], cross(W[j], oorb[c])));
            float dl_n = (rw.bias - dot(v, rw.n)) / rw.wn * omega;
            float ln = fmaxf(loo[c][0] + dl_n, 0.f);
            dl_n = ln - loo[c][0];
            float lt1 = loo[c][1] - dot(v, rw.t1) / rw.wt1 * omega;
            float lt2 = loo[c][2] - dot(v, rw.t2) / rw.wt2 * omega;
            float tn = sqrtf(lt1 * lt1 + lt2 * lt2);
            float sc = fminf(1.f, mu * ln / fmaxf(tn, 1e-9f));
            lt1 *= sc;
            lt2 *= sc;
            V3 P = add(add(scl(rw.n, dl_n), scl(rw.t1, lt1 - loo[c][1])), scl(rw.t2, lt2 - loo[c][2]));
            P = scl(P, rw.act);
            loo[c][0] = ln;
            loo[c][1] = lt1;
            loo[c][2] = lt2;
            dV[i] = add(dV[i], scl(P, invm[i]));
            dW[i] = add(dW[i], sym_apply(iI[i], cross(rw.r, P)));
            dV[j] = sub(dV[j], scl(P, invm[j]));
            dW[j] = sub(dW[j], sym_apply(iI[j], cross(oorb[c], P)));
          }
          for (int k = 0; k < K; ++k) {
            V[k] = add(V[k], dV[k]);
            W[k] = add(W[k], dW[k]);
          }
        }
      }

      // ---- 7. pinch and rolling damping
      if (sp.pinch_damping > 0.f) {
        for (int k = 0; k < K; ++k) {
          if (cntL[k] > 0.f && cntR[k] > 0.f) {
            W[k] = mk(W[k].x - sp.pinch_damping * W[k].x, W[k].y - sp.pinch_damping * W[k].y,
                      W[k].z - sp.pinch_damping * (W[k].z - qd[3]));
          }
        }
      }
      if (sp.rolling_damping > 0.f) {
        for (int k = 0; k < K; ++k) {
          bool touch = false;
          for (int w = 0; w < NS; ++w)
            for (int s = 0; s < S; ++s) touch = touch || st[w * KS + k * S + s].act > 0.f;
          if (touch) W[k] = scl(W[k], 1.f - sp.rolling_damping);
        }
      }

      // remember this substep's normals for the next warm start
      for (int c = 0; c < NS * KS; ++c) nst[c] = st[c].n;
      for (int c = 0; c < KS; ++c) {
        npl[c] = pl[c].n;
        npr[c] = pr[c].n;
      }
      for (int c = 0; c < NOO; ++c) noo[c] = oo[c].n;

      // ---- 8. integrate
      for (int k = 0; k < K; ++k) {
        const float al = alive[k];
        V[k] = mk(clampf(V[k].x, -4.f, 4.f) * al, clampf(V[k].y, -4.f, 4.f) * al,
                  clampf(V[k].z, -4.f, 4.f) * al);
        W[k] = mk(clampf(W[k].x, -50.f, 50.f) * al, clampf(W[k].y, -50.f, 50.f) * al,
                  clampf(W[k].z, -50.f, 50.f) * al);
        pos[k] = add(pos[k], scl(V[k], dt));
        const float ox = W[k].x, oy = W[k].y, oz = W[k].z;
        const float qx = quat[k][0], qy = quat[k][1], qz = quat[k][2], qw = quat[k][3];
        float nq[4] = {qx + 0.5f * dt * (qw * ox + (oy * qz - oz * qy)),
                       qy + 0.5f * dt * (qw * oy + (oz * qx - ox * qz)),
                       qz + 0.5f * dt * (qw * oz + (ox * qy - oy * qx)),
                       qw + 0.5f * dt * (-(ox * qx + oy * qy + oz * qz))};
        float qn = fmaxf(sqrtf(nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2] + nq[3] * nq[3]), 1e-9f);
        for (int c = 0; c < 4; ++c) quat[k][c] = nq[c] / qn;
      }
      for (int d = 0; d < 6; ++d) q[d] += qd[d] * dt;
      for (int d = 4; d < 6; ++d) {
        float f = clampf(q[d], FINGER_LIMIT_LOW, FINGER_LIMIT_HIGH);
        if (f != q[d]) qd[d] = 0.f;
        q[d] = f;
      }
      if (q[2] < floor_q2) {
        q[2] = floor_q2;
        qd[2] = fmaxf(qd[2], 0.f);
      }
    }

    for (int d = 0; d < 6; ++d) {
      q_out[e * 6 + d] = q[d];
      qd_out[e * 6 + d] = qd[d];
    }
    for (int k = 0; k < K; ++k) {
      const int o = e * K + k;
      pos_out[o * 3] = pos[k].x;
      pos_out[o * 3 + 1] = pos[k].y;
      pos_out[o * 3 + 2] = pos[k].z;
      lin_out[o * 3] = V[k].x;
      lin_out[o * 3 + 1] = V[k].y;
      lin_out[o * 3 + 2] = V[k].z;
      ang_out[o * 3] = W[k].x;
      ang_out[o * 3 + 1] = W[k].y;
      ang_out[o * 3 + 2] = W[k].z;
      for (int c = 0; c < 4; ++c) quat_out[o * 4 + c] = quat[k][c];
    }
  }
}

// Host entry: fp holds NFP floats, ip holds NIP ints (host memory), in the
// order of SolverParams. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
extern "C" int solver_run(const float* fp, const int* ip, const float* gq, const float* gqd,
                          const float* gtarget, const float* gftgt, const float* opos,
                          const float* oquat, const float* olin, const float* oang,
                          const float* oalive, const float* lcent, const float* lrad,
                          const float* lcent2, const float* lrad2, const float* linvm,
                          const float* linvI, float* q_out, float* qd_out, float* pos_out,
                          float* quat_out, float* lin_out, float* ang_out, void* stream) {
  SolverParams sp;
  const float* f = fp;
  sp.dt = *f++;
  sp.support_z = *f++;
  sp.tray_half = *f++;
  sp.tray_wall_height = *f++;
  sp.friction = *f++;
  sp.baumgarte = *f++;
  sp.slop = *f++;
  sp.relaxation = *f++;
  sp.gravity = *f++;
  sp.lin_damping = *f++;
  sp.ang_damping = *f++;
  sp.max_bias_velocity = *f++;
  sp.warm_start = *f++;
  sp.pad_omega = *f++;
  sp.pad_bias_scale = *f++;
  sp.rolling_damping = *f++;
  sp.pinch_damping = *f++;
  for (int d = 0; d < 6; ++d) sp.dof_mass[d] = *f++;
  for (int d = 0; d < 6; ++d) sp.dof_force[d] = *f++;
  for (int d = 0; d < 6; ++d) sp.dof_vmax[d] = *f++;
  sp.B = ip[0];
  sp.K = ip[1];
  sp.S = ip[2];
  sp.SC = ip[3];
  sp.n_substeps = ip[4];
  sp.solver_iterations = ip[5];
  sp.pad_inner = ip[6];
  sp.oo_stride = ip[7] < 1 ? 1 : ip[7];
  sp.has_tray = ip[8];
  sp.oo_pm_tangent = ip[9];
  if (sp.K < 1 || sp.K > MAXK || sp.S < 1 || sp.S > MAXS || sp.SC < 1 || sp.SC > MAXSC)
    return (int)cudaErrorInvalidValue;
  if (sp.B <= 0) return 0;
  const int threads = 32;
  const int blocks = (sp.B + threads - 1) / threads;
  solver_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      sp, gq, gqd, gtarget, gftgt, opos, oquat, olin, oang, oalive, lcent, lrad, lcent2, lrad2,
      linvm, linvI, q_out, qd_out, pos_out, quat_out, lin_out, ang_out);
  return (int)cudaGetLastError();
}

extern "C" int solver_limits(int* out) {
  out[0] = MAXK;
  out[1] = MAXS;
  out[2] = MAXSC;
  return 0;
}
