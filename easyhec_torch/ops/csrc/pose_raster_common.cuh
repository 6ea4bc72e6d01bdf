// Device code shared by the fused pose-raster kernels (pose_raster.cu and
// pose_raster_compact.cu): per-triangle setup of one record slot and the
// fixed-order warp and block sums. The math per lane is
// easyhec_tpu/ops/pose_raster.py _chunk_setup; the plain PyTorch version is
// easyhec_torch/ops/pose_raster.py _chunk_setup.
//
// Records: [B, 12, slots] f32, field-major base-frame corner positions
// (x y z w per corner; all-zero = empty slot). cam [B, 16] = Tc[:3,:4]
// row-major | fx fy cx cy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 128
#define REC 12
#define MAX_THREADS 1024

namespace {

constexpr float kEpsZ = 1e-9f;
constexpr float kEpsN = 1e-12f;

// Per-triangle setup of one record slot (pose_raster.py _chunk_setup).
struct Lane {
  float X[REC];               // base-frame record
  float xc[3], yc[3], zc[3];  // camera coords (zc clamped away from 0)
  float u[3], v[3];           // tile-local pixel coords
  float a[3], b[3], c[3];     // normalized edge functions
  float p[3], q[3], n[3], inv[3];
  float lox, loy, hix, hiy;  // bbox, lox poisoned to 1e9 on invalid lanes
  bool valid;
};

__device__ __forceinline__ void lane_setup(const float* __restrict__ slot,
                                           int64_t fstride,
                                           const float* __restrict__ cam,
                                           float x0, float y0, float near,
                                           float far, Lane& L) {
#pragma unroll
  for (int f = 0; f < REC; ++f) L.X[f] = slot[f * fstride];
  const float fx = cam[12], fy = cam[13], cx = cam[14], cy = cam[15];
  bool valid = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float Xb = L.X[4 * i], Yb = L.X[4 * i + 1], Zb = L.X[4 * i + 2],
                Wb = L.X[4 * i + 3];
    const float x = cam[0] * Xb + cam[1] * Yb + cam[2] * Zb + cam[3] * Wb;
    const float y = cam[4] * Xb + cam[5] * Yb + cam[6] * Zb + cam[7] * Wb;
    const float z = cam[8] * Xb + cam[9] * Yb + cam[10] * Zb + cam[11] * Wb;
    valid = valid && (z > near) && (z < far);
    const float zs = fabsf(z) < kEpsZ ? (z < 0.f ? -kEpsZ : kEpsZ) : z;
    L.xc[i] = x;
    L.yc[i] = y;
    L.zc[i] = zs;
    L.u[i] = fx * x / zs + cx - x0;
    L.v[i] = fy * y / zs + cy - y0;
  }
  const float e01u = L.u[1] - L.u[0], e01v = L.v[1] - L.v[0];
  const float e02u = L.u[2] - L.u[0], e02v = L.v[2] - L.v[0];
  const float area2 = e01u * e02v - e01v * e02u;
  valid = valid && (fabsf(area2) > kEpsN);
  const float orient = area2 >= 0.f ? 1.f : -1.f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int ia = e, ib = (e + 1) % 3;
    const float p = L.v[ia] - L.v[ib];
    const float q = L.u[ib] - L.u[ia];
    const float n = fmaxf(sqrtf(p * p + q * q), kEpsN);
    const float inv = orient / n;
    L.p[e] = p;
    L.q[e] = q;
    L.n[e] = n;
    L.inv[e] = inv;
    L.a[e] = p * inv;
    L.b[e] = q * inv;
    L.c[e] = -(L.a[e] * L.u[ia] + L.b[e] * L.v[ia]);
  }
  L.lox = valid ? fminf(fminf(L.u[0], L.u[1]), L.u[2]) : 1e9f;
  L.hix = fmaxf(fmaxf(L.u[0], L.u[1]), L.u[2]);
  L.loy = fminf(fminf(L.v[0], L.v[1]), L.v[2]);
  L.hiy = fmaxf(fmaxf(L.v[0], L.v[1]), L.v[2]);
  L.valid = valid;
}

// Pixel sub-blocks of a tile: each block takes at most MAX_THREADS pixels
// (one thread each), so a tile of P pixels runs as n_sub(P) blocks.
inline int n_sub(int P) { return (P + MAX_THREADS - 1) / MAX_THREADS; }
inline int sub_threads(int P) {
  const int p = P < MAX_THREADS ? P : MAX_THREADS;
  return (p + 31) / 32 * 32;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Fixed-order block sum; the result is valid in thread 0.
__device__ float block_sum(float v, float* s_red) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) s_red[w] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = (threadIdx.x < nw) ? s_red[threadIdx.x] : 0.f;
  if (w == 0) v = warp_sum(v);
  return v;
}

}  // namespace
