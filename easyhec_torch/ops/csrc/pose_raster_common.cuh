// Device code shared by the kernels of ops/csrc (pose_raster.cu,
// pose_raster_compact.cu and, for the Lane that K5 fills with its
// tile-local edges, tile_raster.cu): per-triangle setup of one record slot
// and the fixed-order warp and block sums. The math per lane is
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

template <class Stride>
__device__ __forceinline__ void lane_load(const float* __restrict__ slot,
                                          Stride fstride, Lane& L) {
#pragma unroll
  for (int f = 0; f < REC; ++f) L.X[f] = slot[f * fstride];
}

// The setup of a slot whose record lane_load has read into L.X. Every
// product and sum rounds on its own (__fmul_rn and __fadd_rn are never
// contracted into FMAs), in the order of the plain version's ops, as
// PyTorch's elementwise ops round them: the setup is bit-identical to the
// plain version's, and the forwards and backwards see the same bbox.
__device__ __forceinline__ void lane_project(const float* __restrict__ cam,
                                             float x0, float y0, float near,
                                             float far, Lane& L) {
  const float fx = cam[12], fy = cam[13], cx = cam[14], cy = cam[15];
  bool valid = true;
  auto dot4 = [&](int r, float Xb, float Yb, float Zb, float Wb) {
    return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(cam[r], Xb), __fmul_rn(cam[r + 1], Yb)),
                               __fmul_rn(cam[r + 2], Zb)),
                     __fmul_rn(cam[r + 3], Wb));
  };
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float Xb = L.X[4 * i], Yb = L.X[4 * i + 1], Zb = L.X[4 * i + 2],
                Wb = L.X[4 * i + 3];
    const float x = dot4(0, Xb, Yb, Zb, Wb);
    const float y = dot4(4, Xb, Yb, Zb, Wb);
    const float z = dot4(8, Xb, Yb, Zb, Wb);
    valid = valid && (z > near) && (z < far);
    const float zs = fabsf(z) < kEpsZ ? (z < 0.f ? -kEpsZ : kEpsZ) : z;
    L.xc[i] = x;
    L.yc[i] = y;
    L.zc[i] = zs;
    // a division parts the product from the sums: nothing to contract
    L.u[i] = fx * x / zs + cx - x0;
    L.v[i] = fy * y / zs + cy - y0;
  }
  const float e01u = L.u[1] - L.u[0], e01v = L.v[1] - L.v[0];
  const float e02u = L.u[2] - L.u[0], e02v = L.v[2] - L.v[0];
  const float area2 = __fmul_rn(e01u, e02v) - __fmul_rn(e01v, e02u);
  valid = valid && (fabsf(area2) > kEpsN);
  const float orient = area2 >= 0.f ? 1.f : -1.f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int ia = e, ib = (e + 1) % 3;
    const float p = L.v[ia] - L.v[ib];
    const float q = L.u[ib] - L.u[ia];
    const float n = fmaxf(sqrtf(__fadd_rn(__fmul_rn(p, p), __fmul_rn(q, q))), kEpsN);
    const float inv = orient / n;
    L.p[e] = p;
    L.q[e] = q;
    L.n[e] = n;
    L.inv[e] = inv;
    L.a[e] = __fmul_rn(p, inv);
    L.b[e] = __fmul_rn(q, inv);
    L.c[e] = -__fadd_rn(__fmul_rn(L.a[e], L.u[ia]), __fmul_rn(L.b[e], L.v[ia]));
  }
  L.lox = valid ? fminf(fminf(L.u[0], L.u[1]), L.u[2]) : 1e9f;
  L.hix = fmaxf(fmaxf(L.u[0], L.u[1]), L.u[2]);
  L.loy = fminf(fminf(L.v[0], L.v[1]), L.v[2]);
  L.hiy = fmaxf(fmaxf(L.v[0], L.v[1]), L.v[2]);
  L.valid = valid;
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
