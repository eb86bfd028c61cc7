// Fused depth + segmentation (+ shade) ray-caster, one CUDA thread per pixel.
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
// Shade design. The TPU kernel carries a shade for every candidate through
// its reduction. Here the loop keeps only what the winner's normal needs:
// the winning sphere's index (its normal needs its centre and radius, read
// again after the loop), or -n.d itself for the plane (-d_z), a box (|d|
// along the axis of its largest slab entry, in the box frame) and a wall
// (the same in the world frame). One shade is computed after the loop. The
// depth + seg instantiation (SHADE = false) is the kernel without shade,
// unchanged.
//
// Design. The TPU kernel packs 64x64 pixels into (32, 128) lane tiles and
// renders a few envs per grid step. Here grid = (pixel blocks, envs): each
// thread owns one pixel, loops over the env's primitives (read through the
// read-only cache; every thread of a block reads the same sphere, so the
// loads broadcast) and keeps the nearest-hit reduction in registers. No
// shared memory, no barrier, and every loop has a trip count fixed by the
// launch arguments.
//
// What bounds it on the H100: float32 arithmetic, ~25 operations per
// pixel-sphere pair, ~5 x 10^8 operations per call at B=100 against ~3 MB
// of output, so at peak rates the operations take ~7x longer than the bytes.

#include <cuda_runtime.h>
#include <math.h>

#define PAD_HX 0.010f
#define PAD_HY 0.010f
#define PAD_HZ 0.075f
#define BASE_HX 0.025f
#define BASE_HY 0.025f
#define BASE_HZ 0.055f

struct RasterParams {
  float plane_z, near_, far_, tray_half, wall_height;
  int B, P, H, W, has_tray, gripper_id;
};

__device__ __forceinline__ float safe_div_den(float x) { return fabsf(x) < 1e-9f ? 1e-9f : x; }

// Slab test of a ray (origin o, direction d, both in the box frame) against
// a box of half extents h centred at the origin. Returns t (inf if missed).
// With FACE it also writes *nd, |d| along the axis of the largest slab entry
// (the first such axis on ties, as argmax): -n.d of the entry face. Without
// FACE the tracking is dead code and compiles away.
template <bool FACE>
__device__ __forceinline__ float slab(const float o[3], const float d[3], const float h[3],
                                      float* nd) {
  float tmin = -INFINITY, tmax = INFINITY, lo_best = -INFINITY;
  int ax = 0;
  for (int i = 0; i < 3; ++i) {
    float ds = safe_div_den(d[i]);
    float ta = (-h[i] - o[i]) / ds;
    float tb = (h[i] - o[i]) / ds;
    const float lo = fminf(ta, tb);
    if (FACE && (i == 0 || lo > lo_best)) {
      lo_best = lo;
      ax = i;
    }
    tmin = fmaxf(tmin, lo);
    tmax = fminf(tmax, fmaxf(ta, tb));
  }
  if (FACE) *nd = fabsf(d[ax]);
  bool valid = (tmin < tmax) && (tmax > 0.f);
  float t = tmin > 0.f ? tmin : tmax;
  return valid ? t : INFINITY;
}

template <bool SHADE>
__global__ void raster_kernel(RasterParams rp, const float* __restrict__ sph_c,
                              const float* __restrict__ sph_r, const int* __restrict__ sph_id,
                              const float* __restrict__ box_c, const float* __restrict__ box_R,
                              const float* __restrict__ cam_o, const float* __restrict__ cam_R,
                              const float* __restrict__ intr, float* __restrict__ depth,
                              int* __restrict__ seg, float* __restrict__ shade) {
  const int e = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int HW = rp.H * rp.W;
  if (pix < HW) {  // no barrier follows
    const int px = pix % rp.W, py = pix / rp.W;
    const float* k = intr + e * 4;
    const float u = ((float)px + 0.5f - k[2]) / k[0];
    const float v = ((float)py + 0.5f - k[3]) / k[1];
    const float* R = cam_R + e * 9;
    const float d[3] = {R[0] * u + R[1] * v + R[2], R[3] * u + R[4] * v + R[5],
                        R[6] * u + R[7] * v + R[8]};
    const float o[3] = {cam_o[e * 3], cam_o[e * 3 + 1], cam_o[e * 3 + 2]};
    const float near_ = rp.near_;
    float best = INFINITY;
    int best_id = -1;
    int best_sph = -1;   // SHADE: winning sphere slot, or -1
    float best_nd = 0.f;  // SHADE: -n.d of a winning plane, box or wall

    // support plane
    {
      float t = (rp.plane_z - o[2]) / safe_div_den(d[2]);
      int id = 0;
      if (rp.has_tray) {
        float hx = o[0] + t * d[0], hy = o[1] + t * d[1];
        id = (fabsf(hx) < rp.tray_half && fabsf(hy) < rp.tray_half) ? 2 : 1;
      }
      if (t > 0.f && t >= near_ && t < best) {
        best = t;
        best_id = id;
        if (SHADE) best_nd = -d[2];
      }
    }

    // spheres
    const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    for (int i = 0; i < rp.P; ++i) {
      const int s = e * rp.P + i;
      const float r = __ldg(sph_r + s);
      const float ocx = o[0] - __ldg(sph_c + s * 3);
      const float ocy = o[1] - __ldg(sph_c + s * 3 + 1);
      const float ocz = o[2] - __ldg(sph_c + s * 3 + 2);
      const float b = 2.f * (d[0] * ocx + d[1] * ocy + d[2] * ocz);
      const float c = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r;
      const float disc = b * b - 4.f * a * c;
      const float sq = sqrtf(fmaxf(disc, 0.f));
      const float t = (-b - sq) / (2.f * a);
      if (disc > 0.f && t > 0.f && r > 0.f && t >= near_ && t < best) {
        best = t;
        best_id = __ldg(sph_id + s);
        if (SHADE) best_sph = i;
      }
    }

    // gripper boxes: left pad, right pad, base housing (shared rotation)
    const float* G = box_R + e * 9;
    const float he[3][3] = {{PAD_HX, PAD_HY, PAD_HZ}, {PAD_HX, PAD_HY, PAD_HZ},
                            {BASE_HX, BASE_HY, BASE_HZ}};
    for (int bi = 0; bi < 3; ++bi) {
      const float* bc = box_c + (e * 3 + bi) * 3;
      const float rel[3] = {o[0] - bc[0], o[1] - bc[1], o[2] - bc[2]};
      float ol[3], dl[3];
      for (int j = 0; j < 3; ++j) {  // R^T v
        ol[j] = G[j] * rel[0] + G[3 + j] * rel[1] + G[6 + j] * rel[2];
        dl[j] = G[j] * d[0] + G[3 + j] * d[1] + G[6 + j] * d[2];
      }
      float nd = 0.f;
      const float t = slab<SHADE>(ol, dl, he[bi], &nd);
      if (t >= near_ && t < best) {
        best = t;
        best_id = rp.gripper_id;
        if (SHADE) {
          best_sph = -1;
          best_nd = nd;
        }
      }
    }

    // tray walls (world-axis aligned, id 2)
    if (rp.has_tray) {
      const float th = rp.tray_half, wh = rp.wall_height;
      const float wz = rp.plane_z + wh * 0.5f;
      const float wc[4][3] = {{th + 0.02f, 0.f, wz}, {-(th + 0.02f), 0.f, wz},
                              {0.f, th + 0.02f, wz}, {0.f, -(th + 0.02f), wz}};
      const float wh3[4][3] = {{0.02f, th + 0.04f, wh * 0.5f}, {0.02f, th + 0.04f, wh * 0.5f},
                               {th + 0.04f, 0.02f, wh * 0.5f}, {th + 0.04f, 0.02f, wh * 0.5f}};
      for (int w = 0; w < 4; ++w) {
        const float ol[3] = {o[0] - wc[w][0], o[1] - wc[w][1], o[2] - wc[w][2]};
        float nd = 0.f;
        const float t = slab<SHADE>(ol, d, wh3[w], &nd);
        if (t >= near_ && t < best) {
          best = t;
          best_id = 2;
          if (SHADE) {
            best_sph = -1;
            best_nd = nd;
          }
        }
      }
    }

    const bool hit = best < INFINITY;
    depth[e * HW + pix] = fminf(best, rp.far_);
    seg[e * HW + pix] = hit ? best_id : -1;
    if (SHADE) {
      if (best_sph >= 0) {  // n = (o + t d - c) / r, so -n.d = -(oc.d + t |d|^2) / r
        const int s = e * rp.P + best_sph;
        const float ocx = o[0] - __ldg(sph_c + s * 3);
        const float ocy = o[1] - __ldg(sph_c + s * 3 + 1);
        const float ocz = o[2] - __ldg(sph_c + s * 3 + 2);
        best_nd = -(d[0] * ocx + d[1] * ocy + d[2] * ocz + best * a) /
                  fmaxf(__ldg(sph_r + s), 1e-9f);
      }
      const float ndotl = fminf(fmaxf(best_nd / sqrtf(a), 0.f), 1.f);
      shade[e * HW + pix] = hit ? 0.35f + 0.65f * ndotl : 0.f;
    }
  }
}

// Host entry: fp = (plane_z, near, far, tray_half, wall_height),
// ip = (B, P, H, W, has_tray, gripper_id), both host memory. `shade` is null
// for the depth + seg launch, else the (B, H, W) shade output. Launches on
// `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int raster_run(const float* fp, const int* ip, const float* sph_c, const float* sph_r,
                          const int* sph_id, const float* box_c, const float* box_R,
                          const float* cam_o, const float* cam_R, const float* intr, float* depth,
                          int* seg, float* shade, void* stream) {
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
  if (rp.B <= 0) return 0;
  const int threads = 256;
  dim3 grid((rp.H * rp.W + threads - 1) / threads, rp.B);
  if (shade != nullptr)
    raster_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
        rp, sph_c, sph_r, sph_id, box_c, box_R, cam_o, cam_R, intr, depth, seg, shade);
  else
    raster_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
        rp, sph_c, sph_r, sph_id, box_c, box_R, cam_o, cam_R, intr, depth, seg, nullptr);
  return (int)cudaGetLastError();
}
