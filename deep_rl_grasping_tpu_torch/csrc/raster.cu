// Fused depth + segmentation (+ shade) ray-caster: one block per (env,
// screen tile), one thread per pixel, each tile testing only the spheres
// its rays can hit.
//
// Replaces the Pallas TPU kernel deep_rl_grasping_tpu/ops/raster_pallas.py
// (_raster_kernel :39, called from raster_depth_seg :215 /
// render_batch_pallas :307), including its `with_shade` output
// (raster_pallas.py:204-205). It computes what the port's plain version
// deep_rl_grasping_tpu_torch/render/raycast.py `render_shade` computes (the
// JAX package's render/raycast.py:101): per env, pinhole rays from per-env
// intrinsics; the nearest hit at t >= near among the support plane (floor,
// or table with tray id 2 inside the tray), P spheres, the two finger pads
// and the base box (slab test in the shared gripper frame), and the four
// tray walls; depth = min(t, far), seg = the winner's id or -1, and with
// SHADE the winner's headlight Lambert term 0.35 + 0.65 * clip(-n.d/|d|, 0, 1)
// (0 on a miss). Primitives are tested in the plain version's order with a
// strict `<`, so ties go to the first primitive as argmin does.
//
// What bounds it on the H100. The first design (one thread per pixel over
// all P spheres) spent ~45 instructions per pixel-sphere pair: per pair
// the per-env constants o - c and |o - c|^2 - r^2 again, and an IEEE
// square root and division whether the ray hit or not; per pixel 42 slab
// divisions. A wrist view of 64x64 sees each of the P = 40 spheres over a
// small patch, so most of that work decides nothing. Float32 instructions
// bound it, not its ~3 MB of output. This design removes the work that
// decides nothing:
//
// * Per block, once: the env's camera, gripper rotation and box-frame
//   origins, and per sphere o - c and |o - c|^2 - r^2, in shared memory.
// * Per tile, a sphere list. Pixel (u, v) -> ray R (u, v, 1) is linear, so
//   the rays of a tile lie in the cone spanned by its four corner rays,
//   taken at the tile's outer pixel edges (so each pixel centre's ray is
//   half a pixel inside). A sphere can be hit from the tile only if its
//   centre lies within r of the inner side of each of the cone's four side
//   planes (normals: cross products of adjacent corner rays, oriented
//   towards the corners' sum f) and is not wholly behind the camera
//   (f . (c - o) >= -r, tested where f points into the cone). The first
//   warp tests the P spheres, 32 at a time, and compacts the survivors
//   into the list in index order (ballot and popc prefix), so the tie rule
//   holds. Each pixel then loops over that list only. The tile is fixed
//   at TILE_W x TILE_H = 16 x 8 pixels, chosen by measurement on an H100
//   (PERF.md): 128 threads, 32 tiles of a 64 x 64 image.
// * Per pair: b and the discriminant from the staged constants; the square
//   root and the division only where the discriminant is positive.
// * Per pixel: d in the gripper frame and its reciprocal once for the three
//   gripper boxes, 1/d once for the four walls (6 reciprocals instead of 42
//   divisions).
// * The plane, box and wall hits are taken before the list is ready (the
//   boxes and walls into their own nearest hit, merged after the spheres
//   with a strict `<`, which is the sequential order's tie rule).
//
// The cull is conservative under float32 rounding. A culled sphere's
// centre lies more than r' outside a side plane (or behind the camera),
// so every ray of the tile passes at least r' from it; the test keeps it
// within r' = r + CULL_LINEAR * L + CULL_QUADRATIC * L^2 / r, L = |c - o|.
// CULL_LINEAR covers the test's own rounding: the unit plane normal and
// its dot product with c - o carry a few roundings of terms bounded by L,
// amplified by 1 / sin of the corner rays' angle (> 0.08 rad for tiles of
// 8 pixels or more at the cameras' focal lengths), well under 1e-6 L.
// CULL_QUADRATIC covers the hit test's rounding: the kernel's discriminant
// b^2 - a c is within ~10 u a L^2 (u = 2^-24) of its exact value
// a (r^2 - rho^2), rho the ray's distance from the centre, so rounding can
// report a hit only where rho - r < 5 u L^2 / r < 3e-7 L^2 / r. Both
// margins exceed their error by more than 16x; the half-pixel inset of
// the pixel rays adds an angular margin of ~0.5 / fx on top. Any test that
// is not a number keeps the sphere. Since a culled sphere cannot produce a
// hit, culled and cull-off launches (ip[6] = 0, every live sphere in every
// list, for the check only) give bit-equal outputs; chip_smoke.py and
// tests/test_torch_cuda.py require it. For the same checks the entry
// raster_run_lists also writes each tile's list as a bitmask (the first
// warp's ballots), which they hold against the plain twin of the cull
// (ops/raster_cuda.py check_lists) and from which they count the pairs the
// kernel tests.
//
// What bounds this design on the H100 (PERF.md, tools/raster_probe.py):
// ~0.013 ms at B=100 without shade, while the culled kernel tests ~4.5% of
// the pixel-sphere pairs; the work it needs (those pairs, the per-pixel
// plane, box and wall tests, the cull) is ~9x less time than that at the
// card's peak rates (chip_smoke.py `bound_ms`). Variants without the
// sphere loop, without the gripper boxes or without the stores save 1.3,
// 1.7 and 0.3 us; the rest is per-block latency (staging, the two
// barriers, the first warp's cull) and the launch. More pixels per
// thread, or more resident blocks, are what would move it next.
//
// No atomics and no sums across threads: repeats are bit-equal.

#include <cuda_runtime.h>
#include <math.h>

#define PAD_HX 0.010f
#define PAD_HY 0.010f
#define PAD_HZ 0.075f
#define BASE_HX 0.025f
#define BASE_HY 0.025f
#define BASE_HZ 0.055f

// ops/raster_cuda.py TILE, CULL_LINEAR, CULL_QUADRATIC, CONST_FLOATS,
// SPHERE_BYTES
#define TILE_W 16
#define TILE_H 8
#define TILE_THREADS (TILE_W * TILE_H)
#define CULL_LINEAR 1e-4f
#define CULL_QUADRATIC 1e-5f
// shared constants: camera origin 3, cam_R 9, intrinsics 4, gripper
// rotation G 9, box-frame origins G^T (o - box centre) 3 x 3
#define K_O 0
#define K_R 3
#define K_INTR 12
#define K_G 16
#define K_OL 25
#define CONST_FLOATS 34

struct RasterParams {
  float plane_z, near_, far_, tray_half, wall_height;
  int B, P, H, W, has_tray, gripper_id, cull, tiles_x;
};

// Dynamic shared bytes for P spheres: per sphere a float4 (o - c,
// |o - c|^2 - r^2), its radius and its id; the constants; the list length.
static int raster_shared_bytes(int P) {
  return P * (int)(sizeof(float4) + sizeof(float) + sizeof(int)) +
         (CONST_FLOATS + 1) * (int)sizeof(float);
}

__device__ __forceinline__ float safe_div_den(float x) { return fabsf(x) < 1e-9f ? 1e-9f : x; }

// Slab test of a ray (origin o, direction d with reciprocal inv = 1 / d,
// both in the box frame) against a box of half extents h centred at the
// origin. Returns t (inf if missed). With FACE it also writes *nd, |d|
// along the axis of the largest slab entry (the first such axis on ties, as
// argmax): -n.d of the entry face. Without FACE the tracking is dead code.
template <bool FACE>
__device__ __forceinline__ float slab(const float o[3], const float d[3], const float inv[3],
                                      const float h[3], float* nd) {
  float tmin = -INFINITY, tmax = INFINITY, lo_best = -INFINITY;
  int ax = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ta = (-h[i] - o[i]) * inv[i];
    const float tb = (h[i] - o[i]) * inv[i];
    const float lo = fminf(ta, tb);
    if (FACE && (i == 0 || lo > lo_best)) {
      lo_best = lo;
      ax = i;
    }
    tmin = fmaxf(tmin, lo);
    tmax = fminf(tmax, fmaxf(ta, tb));
  }
  if (FACE) *nd = fabsf(d[ax]);
  const bool valid = (tmin < tmax) && (tmax > 0.f);
  const float t = tmin > 0.f ? tmin : tmax;
  return valid ? t : INFINITY;
}

// Ray of pixel position (x, y) (pixel units, from the image corner).
__device__ __forceinline__ void pixel_ray(const float* R, const float* k, float x, float y,
                                          float d[3]) {
  const float u = (x - k[2]) / k[0];
  const float v = (y - k[3]) / k[1];
  d[0] = R[0] * u + R[1] * v + R[2];
  d[1] = R[3] * u + R[4] * v + R[5];
  d[2] = R[6] * u + R[7] * v + R[8];
}

// The cone of a tile's rays (see the header): the four side planes' inward
// normals n and lengths, the corners' sum f and its length, and whether f
// points into the cone (f . corner > 0 at every corner).
struct TileCone {
  float n[4][3], n_len[4], f[3], f_len;
  bool forward;
};

__device__ void tile_cone(const float* R, const float* k, float x0, float x1, float y0, float y1,
                          TileCone* c) {
  const float xs[4] = {x0, x1, x1, x0}, ys[4] = {y0, y0, y1, y1};
  float d[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i) pixel_ray(R, k, xs[i], ys[i], d[i]);
  for (int j = 0; j < 3; ++j) c->f[j] = d[0][j] + d[1][j] + d[2][j] + d[3][j];
  c->f_len = sqrtf(c->f[0] * c->f[0] + c->f[1] * c->f[1] + c->f[2] * c->f[2]);
  c->forward = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* a = d[i];
    const float* b = d[(i + 1) & 3];
    float n[3] = {a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                  a[0] * b[1] - a[1] * b[0]};
    if (n[0] * c->f[0] + n[1] * c->f[1] + n[2] * c->f[2] < 0.f)
      for (int j = 0; j < 3; ++j) n[j] = -n[j];
    for (int j = 0; j < 3; ++j) c->n[i][j] = n[j];
    c->n_len[i] = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    c->forward = c->forward && (a[0] * c->f[0] + a[1] * c->f[1] + a[2] * c->f[2] > 0.f);
  }
}

// Whether a live sphere of radius r > 0 with s = o - c may be hit by a ray
// of the cone. Rejects only on a comparison that holds; NaN keeps it.
__device__ __forceinline__ bool cone_may_hit(const TileCone& c, float4 s, float r) {
  const float L2 = s.x * s.x + s.y * s.y + s.z * s.z;
  const float rr = r + CULL_LINEAR * sqrtf(L2) + CULL_QUADRATIC * L2 / r;
  bool keep = true;
#pragma unroll
  for (int i = 0; i < 4; ++i)  // c - o = -s
    keep = keep && !(-(c.n[i][0] * s.x + c.n[i][1] * s.y + c.n[i][2] * s.z) < -rr * c.n_len[i]);
  if (c.forward)
    keep = keep && !(-(c.f[0] * s.x + c.f[1] * s.y + c.f[2] * s.z) < -rr * c.f_len);
  return keep;
}

template <bool SHADE>
__global__ void raster_kernel(RasterParams rp, const float* __restrict__ sph_c,
                              const float* __restrict__ sph_r, const int* __restrict__ sph_id,
                              const float* __restrict__ box_c, const float* __restrict__ box_R,
                              const float* __restrict__ cam_o, const float* __restrict__ cam_R,
                              const float* __restrict__ intr, float* __restrict__ depth,
                              int* __restrict__ seg, float* __restrict__ shade,
                              unsigned* __restrict__ lists) {
  extern __shared__ float4 smem[];
  float4* sph = smem;                         // (o - c, |o - c|^2 - r^2) per listed sphere
  float* rad = (float*)(sph + rp.P);          // its radius
  int* sid = (int*)(rad + rp.P);              // its seg id
  float* kc = (float*)(sid + rp.P);           // the env's constants
  int* list_len = (int*)(kc + CONST_FLOATS);  // spheres in the list

  const int e = blockIdx.y;
  const int tid = threadIdx.x;
  const int x0 = (blockIdx.x % rp.tiles_x) * TILE_W;
  const int y0 = (blockIdx.x / rp.tiles_x) * TILE_H;
  const int px = x0 + tid % TILE_W, py = y0 + tid / TILE_W;

  // ---- stage the env's constants
  for (int i = tid; i < CONST_FLOATS; i += TILE_THREADS) {
    float v;
    if (i < K_R) {
      v = cam_o[e * 3 + i];
    } else if (i < K_INTR) {
      v = cam_R[e * 9 + i - K_R];
    } else if (i < K_G) {
      v = intr[e * 4 + i - K_INTR];
    } else if (i < K_OL) {
      v = box_R[e * 9 + i - K_G];
    } else {  // component j of box bi's frame origin: G^T (o - centre)
      const int bi = (i - K_OL) / 3, j = (i - K_OL) % 3;
      const float* G = box_R + e * 9;
      const float* bc = box_c + (e * 3 + bi) * 3;
      const float* o = cam_o + e * 3;
      v = G[j] * (o[0] - bc[0]) + G[3 + j] * (o[1] - bc[1]) + G[6 + j] * (o[2] - bc[2]);
    }
    kc[i] = v;
  }
  __syncthreads();

  const float o[3] = {kc[K_O], kc[K_O + 1], kc[K_O + 2]};
  const float near_ = rp.near_;

  // ---- the first warp: this tile's sphere list, in index order
  if (tid < 32) {
    TileCone cone;
    if (rp.cull)
      tile_cone(kc + K_R, kc + K_INTR, (float)x0, (float)min(x0 + TILE_W, rp.W), (float)y0,
                (float)min(y0 + TILE_H, rp.H), &cone);
    int n = 0;
    for (int i0 = 0; i0 < rp.P; i0 += 32) {
      const int i = i0 + tid;
      bool keep = false;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      float r = 0.f;
      if (i < rp.P) {
        const int g = e * rp.P + i;
        r = sph_r[g];
        s.x = o[0] - sph_c[g * 3];
        s.y = o[1] - sph_c[g * 3 + 1];
        s.z = o[2] - sph_c[g * 3 + 2];
        s.w = (s.x * s.x + s.y * s.y + s.z * s.z) - r * r;
        keep = r > 0.f && (!rp.cull || cone_may_hit(cone, s, r));
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lists != nullptr && tid == 0)  // (env, tile, word) of the list's bitmask
        lists[((size_t)e * gridDim.x + blockIdx.x) * ((rp.P + 31) / 32) + i0 / 32] = ballot;
      if (keep) {
        const int slot = n + __popc(ballot & ((1u << tid) - 1u));
        sph[slot] = s;
        rad[slot] = r;
        sid[slot] = sph_id[e * rp.P + i];
      }
      n += __popc(ballot);
    }
    if (tid == 0) *list_len = n;
  }

  // ---- every thread: its ray, the plane, and the boxes and walls (these
  // come after the spheres in the test order, so they keep their own
  // nearest hit until the merge)
  float d[3];
  pixel_ray(kc + K_R, kc + K_INTR, (float)px + 0.5f, (float)py + 0.5f, d);
  float best = INFINITY;
  int best_id = -1;
  float best_nd = 0.f;  // SHADE: -n.d of a winning plane, box or wall
  {
    const float t = (rp.plane_z - o[2]) / safe_div_den(d[2]);
    int id = 0;
    if (rp.has_tray) {
      const float hx = o[0] + t * d[0], hy = o[1] + t * d[1];
      id = (fabsf(hx) < rp.tray_half && fabsf(hy) < rp.tray_half) ? 2 : 1;
    }
    if (t > 0.f && t >= near_ && t < best) {
      best = t;
      best_id = id;
      if (SHADE) best_nd = -d[2];
    }
  }
  float post = INFINITY;  // nearest box or wall hit
  int post_id = -1;
  float post_nd = 0.f;
  {
    const float* G = kc + K_G;
    float dl[3], inv[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {  // G^T d, shared by the three boxes
      dl[j] = G[j] * d[0] + G[3 + j] * d[1] + G[6 + j] * d[2];
      inv[j] = 1.f / safe_div_den(dl[j]);
    }
    const float he[3][3] = {{PAD_HX, PAD_HY, PAD_HZ}, {PAD_HX, PAD_HY, PAD_HZ},
                            {BASE_HX, BASE_HY, BASE_HZ}};
#pragma unroll
    for (int bi = 0; bi < 3; ++bi) {  // left pad, right pad, base housing
      float nd = 0.f;
      const float t = slab<SHADE>(kc + K_OL + 3 * bi, dl, inv, he[bi], &nd);
      if (t >= near_ && t < post) {
        post = t;
        post_id = rp.gripper_id;
        if (SHADE) post_nd = nd;
      }
    }
  }
  if (rp.has_tray) {  // tray walls, world-axis aligned, id 2
    const float th = rp.tray_half, wh = rp.wall_height;
    const float wz = rp.plane_z + wh * 0.5f;
    const float wc[4][3] = {{th + 0.02f, 0.f, wz}, {-(th + 0.02f), 0.f, wz},
                            {0.f, th + 0.02f, wz}, {0.f, -(th + 0.02f), wz}};
    const float wh3[4][3] = {{0.02f, th + 0.04f, wh * 0.5f}, {0.02f, th + 0.04f, wh * 0.5f},
                             {th + 0.04f, 0.02f, wh * 0.5f}, {th + 0.04f, 0.02f, wh * 0.5f}};
    const float inv[3] = {1.f / safe_div_den(d[0]), 1.f / safe_div_den(d[1]),
                          1.f / safe_div_den(d[2])};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float ol[3] = {o[0] - wc[w][0], o[1] - wc[w][1], o[2] - wc[w][2]};
      float nd = 0.f;
      const float t = slab<SHADE>(ol, d, inv, wh3[w], &nd);
      if (t >= near_ && t < post) {
        post = t;
        post_id = 2;
        if (SHADE) post_nd = nd;
      }
    }
  }
  __syncthreads();

  // ---- the tile's spheres, in index order
  const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const int n = *list_len;
  int best_j = -1;  // winning list entry, or -1
  for (int j = 0; j < n; ++j) {
    const float4 s = sph[j];
    const float bh = d[0] * s.x + d[1] * s.y + d[2] * s.z;  // b / 2
    const float disc = bh * bh - a * s.w;                   // (b^2 - 4 a c) / 4
    if (disc > 0.f) {
      const float t = (-bh - sqrtf(disc)) / a;
      if (t > 0.f && t >= near_ && t < best) {
        best = t;
        best_j = j;
      }
    }
  }
  if (best_j >= 0) best_id = sid[best_j];
  if (post < best) {  // the boxes and walls come after the spheres
    best = post;
    best_id = post_id;
    best_j = -1;
    if (SHADE) best_nd = post_nd;
  }

  if (px < rp.W && py < rp.H) {
    const int HW = rp.H * rp.W;
    const int pix = e * HW + py * rp.W + px;
    const bool hit = best < INFINITY;
    depth[pix] = fminf(best, rp.far_);
    seg[pix] = hit ? best_id : -1;
    if (SHADE) {
      if (best_j >= 0) {  // n = (o + t d - c) / r, so -n.d = -((o - c).d + t |d|^2) / r
        const float4 s = sph[best_j];
        best_nd = -(d[0] * s.x + d[1] * s.y + d[2] * s.z + best * a) / fmaxf(rad[best_j], 1e-9f);
      }
      const float ndotl = fminf(fmaxf(best_nd / sqrtf(a), 0.f), 1.f);
      shade[pix] = hit ? 0.35f + 0.65f * ndotl : 0.f;
    }
  }
}

// Host entry: fp = (plane_z, near, far, tray_half, wall_height); ip = (B, P,
// H, W, has_tray, gripper_id, cull, shared_bytes), both host memory, the
// launch shape from ops/raster_cuda.py `launch_config`. `shade` is null for
// the depth + seg launch, else the (B, H, W) shade output. `lists` is null,
// or (raster_run_lists) a (B, tiles, ceil(P / 32)) word buffer that
// receives each tile's sphere list as a bitmask, bit i of word w for
// sphere 32 w + i. Launches on `stream`; returns cudaErrorInvalidValue for
// a launch shape that does not match P or exceeds the device, else the
// launch's cudaError_t (0 on success).
static int raster_launch(const float* fp, const int* ip, const float* sph_c, const float* sph_r,
                         const int* sph_id, const float* box_c, const float* box_R,
                         const float* cam_o, const float* cam_R, const float* intr, float* depth,
                         int* seg, float* shade, unsigned* lists, void* stream) {
  RasterParams rp;
  rp.plane_z = fp[0];
  rp.near_ = fp[1];
  rp.far_ = fp[2];
  rp.tray_half = fp[3];
  rp.wall_height = fp[4];
  rp.B = ip[0];
  rp.P = ip[1];
  rp.H = ip[2];
  rp.W = ip[3];
  rp.has_tray = ip[4];
  rp.gripper_id = ip[5];
  rp.cull = ip[6];
  const int shared_bytes = ip[7];
  if (rp.P < 0 || rp.H < 1 || rp.W < 1 || rp.B > 65535 ||
      shared_bytes != raster_shared_bytes(rp.P))
    return (int)cudaErrorInvalidValue;
  if (rp.B <= 0) return 0;
  rp.tiles_x = (rp.W + TILE_W - 1) / TILE_W;
  const int tiles = rp.tiles_x * ((rp.H + TILE_H - 1) / TILE_H);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (shared_bytes > optin) return (int)cudaErrorInvalidValue;
  if (shared_bytes > 48 * 1024) {
    err = shade != nullptr
              ? cudaFuncSetAttribute(raster_kernel<true>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes)
              : cudaFuncSetAttribute(raster_kernel<false>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(tiles, rp.B);
  if (shade != nullptr)
    raster_kernel<true><<<grid, TILE_THREADS, shared_bytes, (cudaStream_t)stream>>>(
        rp, sph_c, sph_r, sph_id, box_c, box_R, cam_o, cam_R, intr, depth, seg, shade, lists);
  else
    raster_kernel<false><<<grid, TILE_THREADS, shared_bytes, (cudaStream_t)stream>>>(
        rp, sph_c, sph_r, sph_id, box_c, box_R, cam_o, cam_R, intr, depth, seg, nullptr, lists);
  return (int)cudaGetLastError();
}

extern "C" int raster_run(const float* fp, const int* ip, const float* sph_c, const float* sph_r,
                          const int* sph_id, const float* box_c, const float* box_R,
                          const float* cam_o, const float* cam_R, const float* intr, float* depth,
                          int* seg, float* shade, void* stream) {
  return raster_launch(fp, ip, sph_c, sph_r, sph_id, box_c, box_R, cam_o, cam_R, intr, depth, seg,
                       shade, nullptr, stream);
}

extern "C" int raster_run_lists(const float* fp, const int* ip, const float* sph_c,
                                const float* sph_r, const int* sph_id, const float* box_c,
                                const float* box_R, const float* cam_o, const float* cam_R,
                                const float* intr, float* depth, int* seg, float* shade,
                                unsigned* lists, void* stream) {
  return raster_launch(fp, ip, sph_c, sph_r, sph_id, box_c, box_R, cam_o, cam_R, intr, depth, seg,
                       shade, lists, stream);
}
