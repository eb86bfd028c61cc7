// Contact-solver substep loop for the flying-gripper grasp world: one block
// of two warps per env, the env's contact rows in shared memory, threads
// over rows.
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
// What bounds it on the H100: neither bytes nor FLOPs. The inputs and
// outputs are ~2 KB per env and the work ~6 x 10^6 float operations per env
// per call (~0.01 ms of the card's float32 rate for 128 envs); what takes
// the time is the chain of dependent steps inside one env: 16 substeps x
// (4 iterations x ~20 category phases + ~5), ~1,360 phases, each reading
// the body and gripper velocities the previous one wrote, each a row solve,
// a barrier, a per-body sum and a barrier.
//
// Design. The TPU kernel puts envs on the 128-wide lane axis and holds the
// whole contact working set in VMEM. Here one block of two warps owns one
// env, so at B=100-128 there is about one env per SM and the length of
// that chain is what sets the time. The env's contact rows (geometry,
// solve constants, the three impulses and the previous normal), its
// per-body state (pose, velocities, world inverse inertia) and its sphere
// tables live in dynamic shared memory, sized by the launch's K, S, SC and
// tray walls (`solver_layout`; ~27 KB at the flagship shapes), laid out as
// structure of arrays so that thread i touches row i without bank
// conflicts. Since a category is relaxed Jacobi, its rows are independent:
// contact generation, the warm-start gate and every relaxation sweep put
// one row on each thread (strided over the category; at the flagship
// shapes every static and pad row gets a thread of its own); integration
// and damping put one body on each thread. The per-body impulse sums that
// join a category's rows are taken without atomics, in a fixed order: each
// row writes its dV, dW to a scratch table, then thread (body, component)
// sums its body's rows in row order (the order of the plain version's
// segment sum). The gripper's q, qd and motor impulses are held in
// registers, identical in every thread: the motor rows are 6 scalars that
// each thread computes itself, and the pads' 6 gripper-velocity sums are
// each thread's strided partial sum, folded by a __shfl_xor_sync butterfly
// within each warp and then over the warps in warp order, which gives
// every thread the same bits. So the kernel is deterministic from run to
// run. Every loop has a trip count fixed by the launch arguments; there is
// no convergence loop, and the whole substep loop runs in one launch.

#include <cuda_runtime.h>

#define MAXK 6
#define MAXS 8
#define MAXSC 4
#define WARP 32
#define FULL_MASK 0xffffffffu
// Threads per env: two warps (one block per env). On the flagship shapes
// this puts every pad row (K*S = 40 per side) and every static row on a
// thread of its own; with one warp each pad phase takes two rounds. The
// wrapper passes the same width (ops/solver_cuda.py THREADS_PER_ENV) and
// the C entry refuses any other.
#define THREADS_PER_ENV 64
#define NWARPS (THREADS_PER_ENV / WARP)

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

// ---- shared-memory layout (floats), mirrored by ops/solver_cuda.py
// `launch_config`. A table of n entries keeps field f of entry i at
// base[f * n + i].
// Row fields: normal, tangents, contact point relative to body a's COM,
// effective masses, bias, active flag, impulses, previous normal.
enum {
  NX, NY, NZ, T1X, T1Y, T1Z, T2X, T2Y, T2Z, RX, RY, RZ, WN, WT1, WT2, BIAS, ACT,
  L0, L1, L2, PNX, PNY, PNZ,
  ST_FIELDS  // 23: statics (plane, tray walls)
};
enum { RBX = ST_FIELDS, RBY, PD_FIELDS };             // 25: pad point minus gripper base (x, y)
enum { OBX = ST_FIELDS, OBY, OBZ, OO_FIELDS };        // 26: pair point minus body b's COM
// Body fields: pose, velocities, world inverse inertia (xx yy zz xy xz yz),
// rotation (row-major), inverse mass, alive, local inverse inertia, active
// pad rows per side.
enum {
  PX, PY, PZ, QX, QY, QZ, QW, VX, VY, VZ, WX, WY, WZ, IXX, IYY, IZZ, IXY, IXZ, IYZ,
  R00, R01, R02, R10, R11, R12, R20, R21, R22, INVM, ALIVE, II0, II1, II2, CNTL, CNTR,
  BODY_FIELDS  // 35
};
// Sphere fields (fine spheres and coarse pair spheres): local center,
// radius, world center.
enum { LCX, LCY, LCZ, LRAD, CWX, CWY, CWZ, SPH_FIELDS };  // 7

struct Layout {
  int K, S, SC, NS, KS, NP, NOO, NST, NPD;
  int st, pd, oo, body, sph, crs, wlr, scr, total;  // offsets in floats
};

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ __forceinline__ Layout solver_layout(int K, int S, int SC, int has_tray) {
  Layout L;
  L.K = K;
  L.S = S;
  L.SC = SC;
  L.NS = has_tray ? 5 : 1;
  L.KS = K * S;
  L.NP = (K * (K - 1)) / 2;
  L.NOO = L.NP * SC * SC;
  L.NST = L.NS * L.KS;
  L.NPD = 2 * L.KS;
  int off = 0;
  L.st = off;
  off += ST_FIELDS * L.NST;
  L.pd = off;
  off += PD_FIELDS * L.NPD;
  L.oo = off;
  off += OO_FIELDS * L.NOO;
  L.body = off;
  off += BODY_FIELDS * K;
  L.sph = off;
  off += SPH_FIELDS * L.KS;
  L.crs = off;
  off += SPH_FIELDS * K * SC;
  L.wlr = off;  // cross effective mass of the aligned left/right pad normal rows
  off += L.KS;
  L.scr = off;  // per-row impulse contributions: 6 per row (body a), 12 for pairs (a and b)
  off += imax(6 * imax(L.NST, L.NPD), 12 * L.NOO);
  L.total = off;
  return L;
}

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

// Three consecutive fields f, f+1, f+2 of entry i of a table of n entries.
__device__ __forceinline__ V3 ld3(const float* t, int n, int f, int i) {
  return mk(t[f * n + i], t[(f + 1) * n + i], t[(f + 2) * n + i]);
}
__device__ __forceinline__ void st3(float* t, int n, int f, int i, V3 v) {
  t[f * n + i] = v.x;
  t[(f + 1) * n + i] = v.y;
  t[(f + 2) * n + i] = v.z;
}

// Symmetric world inverse inertia (xx, yy, zz, xy, xz, yz).
struct Sym {
  float xx, yy, zz, xy, xz, yz;
};
__device__ __forceinline__ Sym ld_sym(const float* bd, int K, int k) {
  return {bd[IXX * K + k], bd[IYY * K + k], bd[IZZ * K + k],
          bd[IXY * K + k], bd[IXZ * K + k], bd[IYZ * K + k]};
}
__device__ __forceinline__ V3 sym_apply(const Sym& m, V3 v) {
  return {m.xx * v.x + m.xy * v.y + m.xz * v.z, m.xy * v.x + m.yy * v.y + m.yz * v.z,
          m.xz * v.x + m.yz * v.y + m.zz * v.z};
}
__device__ __forceinline__ float sym_quad(const Sym& m, V3 v) { return dot(v, sym_apply(m, v)); }

// sin and cos of the gripper yaw: Cody-Waite reduction by pi/2 and the
// Cephes minimax polynomials on [-pi/4, pi/4], within 1e-7 of sin and cos
// for |x| < 100 (the yaw is a few radians at most). sinf/cosf would also
// carry a Payne-Hanek path for huge arguments, which needs a local array.
__device__ __forceinline__ void yaw_sincos(float x, float& s, float& c) {
  const float j = rintf(x * 0.636619772f);
  float r = fmaf(j, -1.57079637f, x);
  r = fmaf(j, 4.37113883e-08f, r);
  const float z = r * r;
  const float ps =
      fmaf(fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z, -1.6666654611e-1f), z * r, r);
  const float pc = fmaf(fmaf(fmaf(2.443315711809948e-5f, z, -1.388731625493765e-3f), z,
                             4.166664568298827e-2f),
                        z * z, fmaf(-0.5f, z, 1.f));
  const int quadrant = (int)j & 3;
  s = quadrant == 0 ? ps : (quadrant == 1 ? pc : (quadrant == 2 ? -ps : -pc));
  c = quadrant == 0 ? pc : (quadrant == 1 ? -ps : (quadrant == 2 ? -pc : ps));
}

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
#pragma unroll
  for (int i = 0; i < 3; ++i) dl[i] = l[i] - clampf(l[i], -h[i], h[i]);
  float dist = sqrtf(dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]);
  bool outside = dist > 1e-9f;
  float nl[3];
  float inv = 1.f / fmaxf(dist, 1e-9f);
#pragma unroll
  for (int i = 0; i < 3; ++i) nl[i] = outside ? dl[i] * inv : (i == in_axis ? in_sign : 0.f);
  float l_in = in_axis == 0 ? l[0] : (in_axis == 1 ? l[1] : l[2]);
  float h_in = in_axis == 0 ? h[0] : (in_axis == 1 ? h[1] : h[2]);
  pen = outside ? r - dist : r + h_in - in_sign * l_in;
  n = add(add(scl(ax, nl[0]), scl(ay, nl[1])), scl(az, nl[2]));
}

// One contact row's solve constants, read from its table.
struct Row {
  V3 n, t1, t2, r;
  float wn, wt1, wt2, bias, act;
};
__device__ __forceinline__ Row ld_row(const float* t, int n, int i) {
  Row w;
  w.n = ld3(t, n, NX, i);
  w.t1 = ld3(t, n, T1X, i);
  w.t2 = ld3(t, n, T2X, i);
  w.r = ld3(t, n, RX, i);
  w.wn = t[WN * n + i];
  w.wt1 = t[WT1 * n + i];
  w.wt2 = t[WT2 * n + i];
  w.bias = t[BIAS * n + i];
  w.act = t[ACT * n + i];
  return w;
}
__device__ __forceinline__ void st_row(float* t, int n, int i, const Row& w) {
  st3(t, n, NX, i, w.n);
  st3(t, n, T1X, i, w.t1);
  st3(t, n, T2X, i, w.t2);
  st3(t, n, RX, i, w.r);
  t[WN * n + i] = w.wn;
  t[WT1 * n + i] = w.wt1;
  t[WT2 * n + i] = w.wt2;
  t[BIAS * n + i] = w.bias;
  t[ACT * n + i] = w.act;
}

// Warm start of one freshly built row (physics.py:568-585): the previous
// substep's impulses, gated by normal continuity (zero on the first
// substep); remembers this substep's normal. Returns the impulse to apply.
__device__ __forceinline__ V3 warm_row(float* t, int n, int i, const Row& w, bool first,
                                       float ws) {
  float lam[3] = {0.f, 0.f, 0.f};
  if (!first) {
    const float cont = clampf(dot(ld3(t, n, PNX, i), w.n), 0.f, 1.f);
    const float g = ws * w.act * cont * cont;
    lam[0] = t[L0 * n + i] * g;
    lam[1] = t[L1 * n + i] * g;
    lam[2] = t[L2 * n + i] * g;
  }
  t[L0 * n + i] = lam[0];
  t[L1 * n + i] = lam[1];
  t[L2 * n + i] = lam[2];
  st3(t, n, PNX, i, w.n);
  return scl(add(add(scl(w.n, lam[0]), scl(w.t1, lam[1])), scl(w.t2, lam[2])), w.act);
}

// Gripper-side jacobian of a pad row along d: DOFs (x, y, z, yaw, finger).
__device__ __forceinline__ void pad_jac(V3 d, float rbx, float rby, V3 axis, float j[5]) {
  j[0] = d.x;
  j[1] = d.y;
  j[2] = d.z;
  j[3] = -rby * d.x + rbx * d.y;
  j[4] = dot(axis, d);
}

// Row's contribution to its body: dV = P / m, dW = I^-1 (r x P), into
// scratch fields f0..f0+5 of a table of nr rows.
__device__ __forceinline__ void put_contrib(float* scr, int nr, int f0, int row, V3 P,
                                            float invm, const Sym& iI, V3 r) {
  st3(scr, nr, f0, row, scl(P, invm));
  st3(scr, nr, f0 + 3, row, sym_apply(iI, cross(r, P)));
}

// Sum of x over the warp; every lane gets the same bits (each butterfly
// level adds the same two values in either order, and float addition is
// commutative).
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = WARP / 2; m > 0; m >>= 1) x += __shfl_xor_sync(FULL_MASK, x, m);
  return x;
}

// Barrier among the threads of one env (its block).
__device__ __forceinline__ void env_sync() { __syncthreads(); }

// Sums over the env's threads of 6 values; every thread gets the same bits:
// each warp folds its lanes by the butterfly, then every thread adds the
// warps' sums in warp order from `red` (6 * NWARPS floats).
__device__ __forceinline__ void env_sum6(float v[6], float* red, int tid) {
#pragma unroll
  for (int d = 0; d < 6; ++d) v[d] = warp_sum(v[d]);
  if (tid % WARP == 0)
#pragma unroll
    for (int d = 0; d < 6; ++d) red[d * NWARPS + tid / WARP] = v[d];
  __syncthreads();
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    float acc = red[d * NWARPS];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) acc += red[d * NWARPS + w];
    v[d] = acc;
  }
}

// Per-body sums of a category whose rows of body k are
// g * KS + k * S + s (g < ngroups, s < S): thread (k, component) adds its
// body's rows in row order, then adds the sum to V or W.
__device__ __forceinline__ void reduce_blocks(float* bd, const float* scr, int nr,
                                              int ngroups, const Layout& L, int tid) {
  for (int idx = tid; idx < L.K * 6; idx += THREADS_PER_ENV) {
    const int k = idx / 6, f = idx % 6;
    const float* src = scr + f * nr + k * L.S;
    float acc = 0.f;
    for (int g = 0; g < ngroups; ++g) {
      const float* row = src + g * L.KS;
#pragma unroll
      for (int s = 0; s < MAXS; ++s)
        if (s < L.S) acc += row[s];
    }
    bd[(VX + f) * L.K + k] += acc;  // VX..VZ then WX..WZ
  }
}

__host__ __device__ __forceinline__ int pair_index(int i, int j, int K) {
  return i * K - (i * (i + 1)) / 2 + (j - i - 1);
}

// Per-body sums of the object-pair rows: body k takes minus the b-side
// contributions of pairs (i, k), i < k, then the a-side ones of pairs
// (k, j), in row order.
__device__ __forceinline__ void reduce_pairs(float* bd, const float* scr, const Layout& L,
                                             int tid) {
  const int q = L.SC * L.SC, nr = L.NOO;
  for (int idx = tid; idx < L.K * 6; idx += THREADS_PER_ENV) {
    const int k = idx / 6, f = idx % 6;
    float acc = 0.f;
    for (int i = 0; i < k; ++i) {
      const float* src = scr + (6 + f) * nr + pair_index(i, k, L.K) * q;
      for (int c = 0; c < q; ++c) acc -= src[c];
    }
    for (int j = k + 1; j < L.K; ++j) {
      const float* src = scr + f * nr + pair_index(k, j, L.K) * q;
      for (int c = 0; c < q; ++c) acc += src[c];
    }
    bd[(VX + f) * L.K + k] += acc;
  }
}

// Projected normal + Coulomb friction update of one Jacobi row at relative
// velocity v; returns the impulse increment and stores the new impulses.
__device__ __forceinline__ V3 solve_row(float* t, int n, int i, const Row& w, V3 v, float mu,
                                        float omega) {
  const float l0 = t[L0 * n + i], l1 = t[L1 * n + i], l2 = t[L2 * n + i];
  float dl_n = (w.bias - dot(v, w.n)) / w.wn * omega;
  const float ln = fmaxf(l0 + dl_n, 0.f);
  dl_n = ln - l0;
  float lt1 = l1 - dot(v, w.t1) / w.wt1 * omega;
  float lt2 = l2 - dot(v, w.t2) / w.wt2 * omega;
  const float tn = sqrtf(lt1 * lt1 + lt2 * lt2);
  const float sc = fminf(1.f, mu * ln / fmaxf(tn, 1e-9f));
  lt1 *= sc;
  lt2 *= sc;
  V3 P = add(add(scl(w.n, dl_n), scl(w.t1, lt1 - l1)), scl(w.t2, lt2 - l2));
  t[L0 * n + i] = ln;
  t[L1 * n + i] = lt1;
  t[L2 * n + i] = lt2;
  return scl(P, w.act);
}

__global__ void __launch_bounds__(THREADS_PER_ENV, 1)
    solver_kernel(SolverParams sp, const float* __restrict__ gq, const float* __restrict__ gqd,
                  const float* __restrict__ gtarget, const float* __restrict__ gftgt,
                  const float* __restrict__ opos, const float* __restrict__ oquat,
                  const float* __restrict__ olin, const float* __restrict__ oang,
                  const float* __restrict__ oalive, const float* __restrict__ lcent,
                  const float* __restrict__ lrad, const float* __restrict__ lcent2,
                  const float* __restrict__ lrad2, const float* __restrict__ linvm,
                  const float* __restrict__ linvI, float* __restrict__ q_out,
                  float* __restrict__ qd_out, float* __restrict__ pos_out,
                  float* __restrict__ quat_out, float* __restrict__ lin_out,
                  float* __restrict__ ang_out) {
  extern __shared__ float sm[];
  __shared__ float red[6 * NWARPS];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const Layout L = solver_layout(sp.K, sp.S, sp.SC, sp.has_tray);
  const int K = L.K, S = L.S, SC = L.SC, NS = L.NS, KS = L.KS, NST = L.NST, NPD = L.NPD,
            NOO = L.NOO;
  float* st = sm + L.st;
  float* pd = sm + L.pd;
  float* oo = sm + L.oo;
  float* bd = sm + L.body;
  float* sph = sm + L.sph;
  float* crs = sm + L.crs;
  float* wlr = sm + L.wlr;
  float* scr = sm + L.scr;
  const float dt = sp.dt;
  const float mu = sp.friction, omega = sp.relaxation;
  const float floor_q2 = sp.support_z + PAD_CENTER_DEPTH + PAD_HZ;
  const float bias_coef = sp.baumgarte / dt;

  // Gripper state: registers, the same in every thread.
  float q[6], qd[6], tgt[4], idm[6], a_brake[6];
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    q[d] = gq[e * 6 + d];
    qd[d] = gqd[e * 6 + d];
    idm[d] = 1.f / sp.dof_mass[d];
    // servo plan constants (physics.py:643)
    const float a_max = sp.dof_force[d] / sp.dof_mass[d];
    const float g_load = d == 2 ? -sp.gravity : 0.f;
    a_brake[d] = fmaxf(0.8f * a_max - g_load, 0.5f);
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) tgt[d] = gtarget[e * 4 + d];
  const float ftgt = gftgt[e];

  // Bodies and sphere tables into shared memory.
  for (int k = tid; k < K; k += THREADS_PER_ENV) {
    const int o = e * K + k;
    st3(bd, K, PX, k, mk(opos[o * 3], opos[o * 3 + 1], opos[o * 3 + 2]));
    st3(bd, K, VX, k, mk(olin[o * 3], olin[o * 3 + 1], olin[o * 3 + 2]));
    st3(bd, K, WX, k, mk(oang[o * 3], oang[o * 3 + 1], oang[o * 3 + 2]));
    for (int c = 0; c < 4; ++c) bd[(QX + c) * K + k] = oquat[o * 4 + c];
    for (int c = 0; c < 3; ++c) bd[(II0 + c) * K + k] = linvI[o * 3 + c];
    bd[ALIVE * K + k] = oalive[o];
    bd[INVM * K + k] = linvm[o];
  }
  for (int i = tid; i < KS; i += THREADS_PER_ENV) {
    const int g = e * KS + i;
    st3(sph, KS, LCX, i, mk(lcent[g * 3], lcent[g * 3 + 1], lcent[g * 3 + 2]));
    sph[LRAD * KS + i] = lrad[g];
  }
  for (int i = tid; i < K * SC; i += THREADS_PER_ENV) {
    const int g = e * K * SC + i;
    st3(crs, K * SC, LCX, i, mk(lcent2[g * 3], lcent2[g * 3 + 1], lcent2[g * 3 + 2]));
    crs[LRAD * K * SC + i] = lrad2[g];
  }

  // Tray walls (static OBBs, world-axis aligned).
  const float th = sp.tray_half, wh = sp.tray_wall_height;
  const V3 ex0 = mk(1.f, 0.f, 0.f), ey0 = mk(0.f, 1.f, 0.f), ez = mk(0.f, 0.f, 1.f);
  const float ws = sp.warm_start;
  env_sync();

#pragma unroll 1
  for (int step = 0; step < sp.n_substeps; ++step) {
    const bool first = step == 0;
    // ---- 1. free-velocity update + servo plan
    qd[2] += sp.gravity * dt;
    float v_des[6], cap[6];
    {
      const float full_t[6] = {tgt[0], tgt[1], fmaxf(tgt[2], floor_q2), tgt[3], ftgt, ftgt};
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const float err = full_t[d] - q[d];
        const float v_stop = sqrtf(2.f * a_brake[d] * fabsf(err));
        v_des[d] = sgnf(err) * fminf(fminf(fabsf(err) / dt, v_stop), sp.dof_vmax[d]);
        cap[d] = sp.dof_force[d] * dt;
      }
    }
    // ---- 2. per body: damped free velocity, rotation, world inverse inertia
    {
      const float ld = 1.f - sp.lin_damping * dt, ad = 1.f - sp.ang_damping * dt;
      for (int k = tid; k < K; k += THREADS_PER_ENV) {
        const V3 V = ld3(bd, K, VX, k), W = ld3(bd, K, WX, k);
        st3(bd, K, VX, k, mk(V.x * ld, V.y * ld, (V.z + sp.gravity * dt) * ld));
        st3(bd, K, WX, k, scl(W, ad));
        const float x = bd[QX * K + k], y = bd[QY * K + k], z = bd[QZ * K + k],
                    w = bd[QW * K + k];
        float R[3][3];
        R[0][0] = 1 - 2 * (y * y + z * z);
        R[0][1] = 2 * (x * y - w * z);
        R[0][2] = 2 * (x * z + w * y);
        R[1][0] = 2 * (x * y + w * z);
        R[1][1] = 1 - 2 * (x * x + z * z);
        R[1][2] = 2 * (y * z - w * x);
        R[2][0] = 2 * (x * z - w * y);
        R[2][1] = 2 * (y * z + w * x);
        R[2][2] = 1 - 2 * (x * x + y * y);
        const float i0 = bd[II0 * K + k], i1 = bd[II1 * K + k], i2 = bd[II2 * K + k];
        float m[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            m[a][b] = R[a][0] * i0 * R[b][0] + R[a][1] * i1 * R[b][1] + R[a][2] * i2 * R[b][2];
            bd[(R00 + 3 * a + b) * K + k] = R[a][b];
          }
        bd[IXX * K + k] = m[0][0];
        bd[IYY * K + k] = m[1][1];
        bd[IZZ * K + k] = m[2][2];
        bd[IXY * K + k] = m[0][1];
        bd[IXZ * K + k] = m[0][2];
        bd[IYZ * K + k] = m[1][2];
      }
    }
    // ---- 3. gripper frame (every thread)
    float cyw, syw;
    yaw_sincos(q[3], syw, cyw);
    const V3 ex = mk(cyw, syw, 0.f), ey = mk(-syw, cyw, 0.f);
    const V3 base = mk(q[0], q[1], q[2]);
    const V3 c_l = mk(q[0] - ex.x * (PAD_X_OFFSET - q[4]), q[1] - ex.y * (PAD_X_OFFSET - q[4]),
                      q[2] - PAD_CENTER_DEPTH);
    const V3 c_r = mk(q[0] + ex.x * (PAD_X_OFFSET - q[5]), q[1] + ex.y * (PAD_X_OFFSET - q[5]),
                      q[2] - PAD_CENTER_DEPTH);
    const V3 axis_l = ex, axis_r = scl(ex, -1.f);
    env_sync();

    // ---- 4. world sphere centers, one sphere per thread
    for (int i = tid; i < KS + K * SC; i += THREADS_PER_ENV) {
      const bool fine = i < KS;
      float* tab = fine ? sph : crs;
      const int n = fine ? KS : K * SC;
      const int j = fine ? i : i - KS;
      const int k = j / (fine ? S : SC);
      const V3 lc = ld3(tab, n, LCX, j);
      const V3 p = ld3(bd, K, PX, k);
      st3(tab, n, CWX, j,
          mk(p.x + bd[R00 * K + k] * lc.x + bd[R01 * K + k] * lc.y + bd[R02 * K + k] * lc.z,
             p.y + bd[R10 * K + k] * lc.x + bd[R11 * K + k] * lc.y + bd[R12 * K + k] * lc.z,
             p.z + bd[R20 * K + k] * lc.x + bd[R21 * K + k] * lc.y + bd[R22 * K + k] * lc.z));
    }
    env_sync();

    // ---- 5. rows and their warm starts, one row per thread, category by
    // category (row constants depend on poses only, not on velocities).
    // statics: plane, then walls
    for (int c = tid; c < NST; c += THREADS_PER_ENV) {
      const int w = c / KS, slot = c % KS, k = slot / S;
      const V3 cw = ld3(sph, KS, CWX, slot);
      const float rad = sph[LRAD * KS + slot];
      const bool smask = rad > 0.f && bd[ALIVE * K + k] > 0.5f;
      V3 n;
      float pen;
      if (w == 0) {
        n = ez;
        pen = sp.support_z - (cw.z - rad);
      } else {
        const int wi = w - 1;  // +x, -x, +y, -y wall
        const float cx = wi == 0 ? th + 0.02f : (wi == 1 ? -(th + 0.02f) : 0.f);
        const float cy = wi == 2 ? th + 0.02f : (wi == 3 ? -(th + 0.02f) : 0.f);
        const V3 he = wi < 2 ? mk(0.02f, th + 0.04f, wh * 0.5f) : mk(th + 0.04f, 0.02f, wh * 0.5f);
        sphere_box(cw, rad, mk(cx, cy, sp.support_z + wh * 0.5f), ex0, ey0, ez, he,
                   wi < 2 ? 0 : 1, (wi % 2 == 0) ? -1.f : 1.f, n, pen);
      }
      Row rw;
      rw.n = n;
      rw.r = sub(sub(cw, scl(n, rad)), ld3(bd, K, PX, k));
      rw.act = (smask && pen > 0.f) ? 1.f : 0.f;
      rw.bias = fminf(bias_coef * fmaxf(pen - sp.slop, 0.f), sp.max_bias_velocity);
      tangent_basis(n, rw.t1, rw.t2);
      const Sym iI = ld_sym(bd, K, k);
      const float im = bd[INVM * K + k];
      rw.wn = fmaxf(im + sym_quad(iI, cross(rw.r, rw.n)), 1e-9f);
      rw.wt1 = fmaxf(im + sym_quad(iI, cross(rw.r, rw.t1)), 1e-9f);
      rw.wt2 = fmaxf(im + sym_quad(iI, cross(rw.r, rw.t2)), 1e-9f);
      st_row(st, NST, c, rw);
      put_contrib(scr, NST, 0, c, warm_row(st, NST, c, rw, first, ws), im, iI, rw.r);
    }
    env_sync();
    if (!first) {
      reduce_blocks(bd, scr, NST, NS, L, tid);
      env_sync();
    }

    // finger pads: rows side * KS + slot
    {
      float dq[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int c = tid; c < NPD; c += THREADS_PER_ENV) {
        const int side = c / KS, slot = c % KS, k = slot / S;
        const V3 cw = ld3(sph, KS, CWX, slot);
        const float rad = sph[LRAD * KS + slot];
        const bool smask = rad > 0.f && bd[ALIVE * K + k] > 0.5f;
        V3 n;
        float pen;
        sphere_box(cw, rad, side == 0 ? c_l : c_r, ex, ey, ez, mk(PAD_HX, PAD_HY, PAD_HZ), 0,
                   side == 0 ? 1.f : -1.f, n, pen);
        const V3 axis = side == 0 ? axis_l : axis_r;
        const V3 pt = sub(cw, scl(n, rad));
        Row rw;
        rw.n = n;
        rw.r = sub(pt, ld3(bd, K, PX, k));
        const float rbx = pt.x - base.x, rby = pt.y - base.y;
        rw.act = (smask && pen > 0.f) ? 1.f : 0.f;
        rw.bias = fminf(bias_coef * fmaxf(pen - sp.slop, 0.f), sp.max_bias_velocity);
        tangent_basis(n, rw.t1, rw.t2);
        const Sym iI = ld_sym(bd, K, k);
        const float im = bd[INVM * K + k];
        const float idf = side == 0 ? idm[4] : idm[5];
        const V3 dirs[3] = {rw.n, rw.t1, rw.t2};
        float wdir[3];
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          float j[5];
          pad_jac(dirs[di], rbx, rby, axis, j);
          wdir[di] = fmaxf(im + sym_quad(iI, cross(rw.r, dirs[di])) + j[0] * j[0] * idm[0] +
                               j[1] * j[1] * idm[1] + j[2] * j[2] * idm[2] +
                               j[3] * j[3] * idm[3] + j[4] * j[4] * idf,
                           1e-9f);
        }
        rw.wn = wdir[0];
        rw.wt1 = wdir[1];
        rw.wt2 = wdir[2];
        st_row(pd, NPD, c, rw);
        pd[RBX * NPD + c] = rbx;
        pd[RBY * NPD + c] = rby;
        const V3 P = warm_row(pd, NPD, c, rw, first, ws);
        put_contrib(scr, NPD, 0, c, P, im, iI, rw.r);
        float j[5];
        pad_jac(P, rbx, rby, axis, j);
#pragma unroll
        for (int d = 0; d < 4; ++d) dq[d] -= j[d] * idm[d];
        if (side == 0)
          dq[4] -= j[4] * idm[4];
        else
          dq[5] -= j[4] * idm[5];
      }
      env_sync();
      // active pad rows per body and side; the aligned pair's cross mass
      for (int k = tid; k < K; k += THREADS_PER_ENV) {
        float nl = 0.f, nr = 0.f;
        for (int s = 0; s < S; ++s) {
          nl += pd[ACT * NPD + k * S + s];
          nr += pd[ACT * NPD + KS + k * S + s];
        }
        bd[CNTL * K + k] = nl;
        bd[CNTR * K + k] = nr;
      }
      for (int slot = tid; slot < KS; slot += THREADS_PER_ENV) {
        const int k = slot / S, cr = KS + slot;
        const V3 nL = ld3(pd, NPD, NX, slot), nR = ld3(pd, NPD, NX, cr);
        const V3 rL = ld3(pd, NPD, RX, slot), rR = ld3(pd, NPD, RX, cr);
        float jl[5], jr[5];
        pad_jac(nL, pd[RBX * NPD + slot], pd[RBY * NPD + slot], axis_l, jl);
        pad_jac(nR, pd[RBX * NPD + cr], pd[RBY * NPD + cr], axis_r, jr);
        const float w_obj = bd[INVM * K + k] * dot(nL, nR) +
                            dot(cross(rL, nL), sym_apply(ld_sym(bd, K, k), cross(rR, nR)));
        const float w_dof = jl[0] * idm[0] * jr[0] + jl[1] * idm[1] * jr[1] +
                            jl[2] * idm[2] * jr[2] + jl[3] * idm[3] * jr[3];
        wlr[slot] = (w_obj + w_dof) * (pd[ACT * NPD + slot] * pd[ACT * NPD + cr]);
      }
      if (!first) {
        reduce_blocks(bd, scr, NPD, 2, L, tid);
        env_sum6(dq, red, tid);
#pragma unroll
        for (int d = 0; d < 6; ++d) qd[d] += dq[d];
      }
      env_sync();
    }

    // object pairs (coarse spheres): rows (pair, a, b)
    if (NOO > 0) {
      const int q2 = SC * SC, nc = K * SC;
      for (int c = tid; c < NOO; c += THREADS_PER_ENV) {
        int p = c / q2, i = 0;
        while (p >= K - 1 - i) {
          p -= K - 1 - i;
          ++i;
        }
        const int j = i + 1 + p;
        const int a = (c % q2) / SC, b = c % SC;
        const V3 ca = ld3(crs, nc, CWX, i * SC + a), cb = ld3(crs, nc, CWX, j * SC + b);
        const float ra = crs[LRAD * nc + i * SC + a], rbd = crs[LRAD * nc + j * SC + b];
        const V3 d = sub(ca, cb);
        const float dist = sqrtf(dot(d, d));
        const float rsum = ra + rbd;
        const float pen = rsum - dist;
        const V3 n = scl(d, 1.f / fmaxf(dist, 1e-9f));
        const V3 pt = add(cb, scl(n, rbd + 0.5f * (dist - rsum)));
        const bool m = ra > 0.f && rbd > 0.f && bd[ALIVE * K + i] > 0.5f &&
                       bd[ALIVE * K + j] > 0.5f;
        const Sym iIi = ld_sym(bd, K, i), iIj = ld_sym(bd, K, j);
        const float imi = bd[INVM * K + i], imj = bd[INVM * K + j];
        Row rw;
        rw.n = n;
        rw.r = sub(pt, ld3(bd, K, PX, i));
        const V3 rb = sub(pt, ld3(bd, K, PX, j));
        rw.act = (m && pen > 0.f) ? 1.f : 0.f;
        rw.bias = fminf(bias_coef * fmaxf(pen - sp.slop, 0.f), sp.max_bias_velocity);
        tangent_basis(n, rw.t1, rw.t2);
        rw.wn = fmaxf(imi + sym_quad(iIi, cross(rw.r, n)) + imj + sym_quad(iIj, cross(rb, n)),
                      1e-9f);
        if (sp.oo_pm_tangent) {
          rw.wt1 = rw.wt2 = fmaxf(imi + imj, 1e-9f);
        } else {
          rw.wt1 = fmaxf(imi + sym_quad(iIi, cross(rw.r, rw.t1)) + imj +
                             sym_quad(iIj, cross(rb, rw.t1)),
                         1e-9f);
          rw.wt2 = fmaxf(imi + sym_quad(iIi, cross(rw.r, rw.t2)) + imj +
                             sym_quad(iIj, cross(rb, rw.t2)),
                         1e-9f);
        }
        st_row(oo, NOO, c, rw);
        st3(oo, NOO, OBX, c, rb);
        const V3 P = warm_row(oo, NOO, c, rw, first, ws);
        put_contrib(scr, NOO, 0, c, P, imi, iIi, rw.r);
        put_contrib(scr, NOO, 6, c, P, imj, iIj, rb);
      }
      env_sync();
      if (!first) {
        reduce_pairs(bd, scr, L, tid);
        env_sync();
      }
    }

    // ---- 6. solver iterations
    float lam_m[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int it = 0; it < sp.solver_iterations; ++it) {
      // statics
      for (int c = tid; c < NST; c += THREADS_PER_ENV) {
        const Row rw = ld_row(st, NST, c);
        const int k = (c % KS) / S;
        const V3 v = add(ld3(bd, K, VX, k), cross(ld3(bd, K, WX, k), rw.r));
        const V3 P = solve_row(st, NST, c, rw, v, mu, omega);
        put_contrib(scr, NST, 0, c, P, bd[INVM * K + k], ld_sym(bd, K, k), rw.r);
      }
      env_sync();
      reduce_blocks(bd, scr, NST, NS, L, tid);
      env_sync();

#pragma unroll 1
      for (int pass = 0; pass < sp.pad_inner; ++pass) {
        // motor rows: exact 1-D clamped projection per DOF (every thread)
#pragma unroll
        for (int d = 0; d < 6; ++d) {
          const float ln = clampf(lam_m[d] + (v_des[d] - qd[d]) * sp.dof_mass[d], -cap[d], cap[d]);
          qd[d] += (ln - lam_m[d]) / sp.dof_mass[d];
          lam_m[d] = ln;
        }
        // coupled 2x2 normal solve of the opposing pads (physics.py:435), one slot per thread
        {
          float dq[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          for (int c = tid; c < KS; c += THREADS_PER_ENV) {
            const int k = c / S, cr = KS + c;
            const V3 nL = ld3(pd, NPD, NX, c), nR = ld3(pd, NPD, NX, cr);
            const V3 rL = ld3(pd, NPD, RX, c), rR = ld3(pd, NPD, RX, cr);
            const float rlx = pd[RBX * NPD + c], rly = pd[RBY * NPD + c];
            const float rrx = pd[RBX * NPD + cr], rry = pd[RBY * NPD + cr];
            const float actL = pd[ACT * NPD + c], actR = pd[ACT * NPD + cr];
            float jl[5], jr[5];
            pad_jac(nL, rlx, rly, axis_l, jl);
            pad_jac(nR, rrx, rry, axis_r, jr);
            const V3 Vk = ld3(bd, K, VX, k), Wk = ld3(bd, K, WX, k);
            const float vL = dot(add(Vk, cross(Wk, rL)), nL) -
                             (jl[0] * qd[0] + jl[1] * qd[1] + jl[2] * qd[2] + jl[3] * qd[3] +
                              jl[4] * qd[4]);
            const float vR = dot(add(Vk, cross(Wk, rR)), nR) -
                             (jr[0] * qd[0] + jr[1] * qd[1] + jr[2] * qd[2] + jr[3] * qd[3] +
                              jr[4] * qd[5]);
            const float w_ll = pd[WN * NPD + c], w_rr = pd[WN * NPD + cr], w_lr = wlr[c];
            const float bL = sp.pad_bias_scale * pd[BIAS * NPD + c] - vL;
            const float bR = sp.pad_bias_scale * pd[BIAS * NPD + cr] - vR;
            const float det = fmaxf(w_ll * w_rr - w_lr * w_lr, 1e-4f * w_ll * w_rr);
            const float lLn = pd[L0 * NPD + c], lRn = pd[L0 * NPD + cr];
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
            newL = lLn + (newL - lLn) / fmaxf(bd[CNTL * K + k], 1.f);
            newR = lRn + (newR - lRn) / fmaxf(bd[CNTR * K + k], 1.f);
            pd[L0 * NPD + c] = newL;
            pd[L0 * NPD + cr] = newR;
            const V3 PL = scl(nL, (newL - lLn) * actL);
            const V3 PR = scl(nR, (newR - lRn) * actR);
            st3(scr, KS, 0, c, scl(add(PL, PR), bd[INVM * K + k]));
            st3(scr, KS, 3, c, sym_apply(ld_sym(bd, K, k), add(cross(rL, PL), cross(rR, PR))));
            float gl[5], gr[5];
            pad_jac(PL, rlx, rly, axis_l, gl);
            pad_jac(PR, rrx, rry, axis_r, gr);
#pragma unroll
            for (int d = 0; d < 4; ++d) dq[d] -= (gl[d] + gr[d]) * idm[d];
            dq[4] -= gl[4] * idm[4];
            dq[5] -= gr[4] * idm[5];
          }
          env_sync();
          reduce_blocks(bd, scr, KS, 1, L, tid);
          env_sum6(dq, red, tid);
#pragma unroll
          for (int d = 0; d < 6; ++d) qd[d] += dq[d];
          env_sync();
        }
        // pad friction: left, then right (physics.py:505-510)
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const V3 axis = side == 0 ? axis_l : axis_r;
          const float qf = side == 0 ? qd[4] : qd[5];
          float dq[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          for (int c = tid; c < KS; c += THREADS_PER_ENV) {
            const int k = c / S, i = side * KS + c;
            const Row rw = ld_row(pd, NPD, i);
            const float rbx = pd[RBX * NPD + i], rby = pd[RBY * NPD + i];
            float j1[5], j2[5];
            pad_jac(rw.t1, rbx, rby, axis, j1);
            pad_jac(rw.t2, rbx, rby, axis, j2);
            const V3 v = add(ld3(bd, K, VX, k), cross(ld3(bd, K, WX, k), rw.r));
            const float vt1 = dot(v, rw.t1) - (j1[0] * qd[0] + j1[1] * qd[1] + j1[2] * qd[2] +
                                               j1[3] * qd[3] + j1[4] * qf);
            const float vt2 = dot(v, rw.t2) - (j2[0] * qd[0] + j2[1] * qd[1] + j2[2] * qd[2] +
                                               j2[3] * qd[3] + j2[4] * qf);
            const float l0 = pd[L0 * NPD + i], l1 = pd[L1 * NPD + i], l2 = pd[L2 * NPD + i];
            float lt1 = l1 - vt1 / rw.wt1 * sp.pad_omega;
            float lt2 = l2 - vt2 / rw.wt2 * sp.pad_omega;
            const float tn = sqrtf(lt1 * lt1 + lt2 * lt2);
            const float sc = fminf(1.f, mu * l0 / fmaxf(tn, 1e-9f));
            lt1 *= sc;
            lt2 *= sc;
            const float d1 = (lt1 - l1) * rw.act, d2 = (lt2 - l2) * rw.act;
            pd[L1 * NPD + i] = lt1;
            pd[L2 * NPD + i] = lt2;
            const V3 P = add(scl(rw.t1, d1), scl(rw.t2, d2));
            put_contrib(scr, KS, 0, c, P, bd[INVM * K + k], ld_sym(bd, K, k), rw.r);
            float gj[5];
            pad_jac(P, rbx, rby, axis, gj);
#pragma unroll
            for (int d = 0; d < 4; ++d) dq[d] -= gj[d] * idm[d];
            dq[4 + side] -= gj[4] * idm[4 + side];
          }
          env_sync();
          reduce_blocks(bd, scr, KS, 1, L, tid);
          env_sum6(dq, red, tid);
#pragma unroll
          for (int d = 0; d < 6; ++d) qd[d] += dq[d];
          env_sync();
        }
      }

      // object-object rows every oo_stride iterations (always on the first)
      if (NOO > 0 && it % sp.oo_stride == 0) {
        for (int c = tid; c < NOO; c += THREADS_PER_ENV) {
          int p = c / (SC * SC), i = 0;
          while (p >= K - 1 - i) {
            p -= K - 1 - i;
            ++i;
          }
          const int j = i + 1 + p;
          const Row rw = ld_row(oo, NOO, c);
          const V3 rb = ld3(oo, NOO, OBX, c);
          const V3 v = sub(add(ld3(bd, K, VX, i), cross(ld3(bd, K, WX, i), rw.r)),
                           add(ld3(bd, K, VX, j), cross(ld3(bd, K, WX, j), rb)));
          const V3 P = solve_row(oo, NOO, c, rw, v, mu, omega);
          put_contrib(scr, NOO, 0, c, P, bd[INVM * K + i], ld_sym(bd, K, i), rw.r);
          put_contrib(scr, NOO, 6, c, P, bd[INVM * K + j], ld_sym(bd, K, j), rb);
        }
        env_sync();
        reduce_pairs(bd, scr, L, tid);
        env_sync();
      }
    }

    // ---- 7. pinch and rolling damping, then integration, one body per thread
    for (int k = tid; k < K; k += THREADS_PER_ENV) {
      V3 W = ld3(bd, K, WX, k);
      if (sp.pinch_damping > 0.f && bd[CNTL * K + k] > 0.f && bd[CNTR * K + k] > 0.f)
        W = mk(W.x - sp.pinch_damping * W.x, W.y - sp.pinch_damping * W.y,
               W.z - sp.pinch_damping * (W.z - qd[3]));
      if (sp.rolling_damping > 0.f) {
        bool touch = false;
        for (int w = 0; w < NS; ++w)
          for (int s = 0; s < S; ++s) touch = touch || st[ACT * NST + w * KS + k * S + s] > 0.f;
        if (touch) W = scl(W, 1.f - sp.rolling_damping);
      }
      const float al = bd[ALIVE * K + k];
      V3 V = ld3(bd, K, VX, k);
      V = mk(clampf(V.x, -4.f, 4.f) * al, clampf(V.y, -4.f, 4.f) * al, clampf(V.z, -4.f, 4.f) * al);
      W = mk(clampf(W.x, -50.f, 50.f) * al, clampf(W.y, -50.f, 50.f) * al,
             clampf(W.z, -50.f, 50.f) * al);
      st3(bd, K, VX, k, V);
      st3(bd, K, WX, k, W);
      st3(bd, K, PX, k, add(ld3(bd, K, PX, k), scl(V, dt)));
      const float ox = W.x, oy = W.y, oz = W.z;
      const float qx = bd[QX * K + k], qy = bd[QY * K + k], qz = bd[QZ * K + k],
                  qw = bd[QW * K + k];
      float nq[4] = {qx + 0.5f * dt * (qw * ox + (oy * qz - oz * qy)),
                     qy + 0.5f * dt * (qw * oy + (oz * qx - ox * qz)),
                     qz + 0.5f * dt * (qw * oz + (ox * qy - oy * qx)),
                     qw + 0.5f * dt * (-(ox * qx + oy * qy + oz * qz))};
      const float qn =
          fmaxf(sqrtf(nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2] + nq[3] * nq[3]), 1e-9f);
#pragma unroll
      for (int c = 0; c < 4; ++c) bd[(QX + c) * K + k] = nq[c] / qn;
    }
    // gripper (every thread)
#pragma unroll
    for (int d = 0; d < 6; ++d) q[d] += qd[d] * dt;
#pragma unroll
    for (int d = 4; d < 6; ++d) {
      const float f = clampf(q[d], FINGER_LIMIT_LOW, FINGER_LIMIT_HIGH);
      if (f != q[d]) qd[d] = 0.f;
      q[d] = f;
    }
    if (q[2] < floor_q2) {
      q[2] = floor_q2;
      qd[2] = fmaxf(qd[2], 0.f);
    }
    env_sync();
  }

  if (tid < 6) {
    float qv = q[0], qdv = qd[0];
#pragma unroll
    for (int d = 1; d < 6; ++d)
      if (tid == d) {
        qv = q[d];
        qdv = qd[d];
      }
    q_out[e * 6 + tid] = qv;
    qd_out[e * 6 + tid] = qdv;
  }
  for (int k = tid; k < K; k += THREADS_PER_ENV) {
    const int o = e * K + k;
    const V3 p = ld3(bd, K, PX, k), V = ld3(bd, K, VX, k), W = ld3(bd, K, WX, k);
    pos_out[o * 3] = p.x;
    pos_out[o * 3 + 1] = p.y;
    pos_out[o * 3 + 2] = p.z;
    lin_out[o * 3] = V.x;
    lin_out[o * 3 + 1] = V.y;
    lin_out[o * 3 + 2] = V.z;
    ang_out[o * 3] = W.x;
    ang_out[o * 3 + 1] = W.y;
    ang_out[o * 3 + 2] = W.z;
    for (int c = 0; c < 4; ++c) quat_out[o * 4 + c] = bd[(QX + c) * K + k];
  }
}

// Host entry: fp holds the float parameters in the order of SolverParams;
// ip holds B, K, S, SC, n_substeps, solver_iterations, pad_inner,
// oo_stride, has_tray, oo_pm_tangent, then the launch shape that
// ops/solver_cuda.py `launch_config` computed: threads per block and
// dynamic shared bytes per block (one env per block). The entry checks the
// shape against its own layout and the device's limit and returns an error
// instead of launching what the device would refuse. Launches on `stream`
// and returns the launch's cudaError_t (0 on success); it does not
// synchronise.
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
  const int threads = ip[10], shared_bytes = ip[11];
  if (sp.K < 1 || sp.K > MAXK || sp.S < 1 || sp.S > MAXS || sp.SC < 1 || sp.SC > MAXSC)
    return (int)cudaErrorInvalidValue;
  const Layout L = solver_layout(sp.K, sp.S, sp.SC, sp.has_tray);
  if (threads != THREADS_PER_ENV || shared_bytes != (int)(L.total * sizeof(float)))
    return (int)cudaErrorInvalidValue;
  if (sp.B <= 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (shared_bytes > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(solver_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             shared_bytes);
  if (err != cudaSuccess) return (int)err;
  solver_kernel<<<sp.B, threads, shared_bytes, (cudaStream_t)stream>>>(
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

// The compiled kernel's resources: registers per thread, local (stack and
// spill) bytes per thread, the most threads a block may have, static
// shared bytes. The dynamic shared bytes depend on the launch's shape
// (ops/solver_cuda.py `launch_config`).
extern "C" int solver_attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, solver_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.sharedSizeBytes;
  return 0;
}
