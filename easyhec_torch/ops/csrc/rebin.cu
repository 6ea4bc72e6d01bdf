// The fused routes' bin state around the binner, for Hopper (sm_90a): the
// triangle setup that feeds binning.cu and the compact pack that reads its
// lists (render/fused.py::build_compact_state and _fused_bins_and_fields on
// CUDA tensors, through ops/rebin.py).
//
// Replaces no Pallas kernel: the JAX package builds the bin state with XLA
// (easyhec_tpu/render/fused.py). The plain versions are render/fused.py's
// _tri_setup_plain (projection.py::setup_triangles_corners, the bboxes and
// _base_corner_fields) and _compact_pack_plain, ~150 small PyTorch kernels a
// bin state between them. These give the same arrays bit for bit.
//
// Floating point as the plain version: every product, sum and quotient is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; no
// contraction into FMAs), in the plain version's order. The plain version's
// product with the 0/1 face-link one-hot selects one link's pose exactly, so
// the setup reads that link's pose directly.
//
// Design: three kernels, no global atomics (the scan's one shared atomicMax
// finds a frame's last non-empty tile), no host reads; each allocates nothing,
// so they can be captured in a CUDA graph or a conditional node's body.
//   tri_setup_kernel    (chunk of 256 faces, frame): one thread a face:
//                       camera-frame corners, z_safe, the projection, the
//                       near/far, degenerate and back-face culls, the
//                       margin-dilated bbox, the bbox centre row (suby) and
//                       the 12 base-frame field rows (w rows = valid).
//   compact_scan_kernel (frame), 1024 threads: chunks per tile
//                       ceil(count / 128), their exclusive scan (starts),
//                       ncu; then each real chunk's tile and live slots, the
//                       padding chunks (tile of the last real chunk, or the
//                       last tile on an empty frame; nlive 0) and the
//                       backward's identity chunk map.
//   compact_gather_kernel (chunk, frame), 128 threads: one slot a thread,
//                       the 12 field rows of its triangle (read from the
//                       binner's int32 lists) or the zero record where the
//                       slot is not live; block (0, 0) also reduces the
//                       overflow flag (any bin overflow, or ncu past nc).
// No static limit on the frames' tiles, chunks or capacity: the scan walks
// the tiles in passes of 1024 and the gather's grid is (nc, B).

#include <cuda_runtime.h>

namespace {

constexpr int SETUP_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int CHUNK = 128;  // record slots per compact chunk (ops/pose_raster.py)
constexpr int FIELDS = 12;  // POSE_RECORD: x y z w of three corners

__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// ((p0 r0 + p1 r1) + p2 r2) + p3 r3, each op rounded on its own.
__device__ __forceinline__ float row_dot(const float* p, const float r[4]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[0], r[0]), __fmul_rn(p[1], r[1])),
                             __fmul_rn(p[2], r[2])),
                   __fmul_rn(p[3], r[3]));
}

struct Setup {
  const float* corners;  // [3, 4, F] homogeneous rest corners
  const int* link;       // [F] link of each face
  const float* cam;      // [B, L, 4, 4] camera-from-link
  const float* base;     // [B, L, 4, 4] base-from-link
  const float* K;        // [3, 3] intrinsics
  float* box;            // [5, B, F]: lox - m, loy - m, hix + m, hiy + m, suby
  unsigned char* valid;  // [B, F]
  float* fields;         // [B, 12, F + 1], the last column zero
  int B, F, L, subsort, cull;
  float margin, near, far, eps_z, eps_area;
};

// grid (cdiv(F, SETUP_THREADS), B)
__global__ void __launch_bounds__(SETUP_THREADS) tri_setup_kernel(Setup s) {
  const int b = blockIdx.y, f = blockIdx.x * SETUP_THREADS + threadIdx.x;
  const size_t F1 = (size_t)s.F + 1;
  float* fb = s.fields + (size_t)b * FIELDS * F1;
  if (f == 0) {  // the sentinel column the dense pack gathers for empty slots
    for (int i = 0; i < FIELDS; ++i) fb[i * F1 + s.F] = 0.f;
  }
  if (f >= s.F) return;
  const float fx = s.K[0], fy = s.K[4], cx = s.K[2], cy = s.K[5];
  const size_t pose = ((size_t)b * s.L + s.link[f]) * 16;
  const float* P = s.cam + pose;
  const float* Q = s.base + pose;
  float x[3], y[3], z[3], u[3], v[3];
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = s.corners[(size_t)(c * 4 + j) * s.F + f];
    x[c] = row_dot(P, r);
    y[c] = row_dot(P + 4, r);
    z[c] = row_dot(P + 8, r);
#pragma unroll
    for (int i = 0; i < 3; ++i) fb[(c * 4 + i) * F1 + f] = row_dot(Q + 4 * i, r);
    const float zs = fabsf(z[c]) < s.eps_z ? (z[c] < 0.f ? -s.eps_z : s.eps_z) : z[c];
    u[c] = __fadd_rn(__fdiv_rn(__fmul_rn(fx, x[c]), zs), cx);
    v[c] = __fadd_rn(__fdiv_rn(__fmul_rn(fy, y[c]), zs), cy);
    ok = ok && z[c] > s.near && z[c] < s.far;
  }
  const float e01u = __fsub_rn(u[1], u[0]), e01v = __fsub_rn(v[1], v[0]);
  const float e02u = __fsub_rn(u[2], u[0]), e02v = __fsub_rn(v[2], v[0]);
  const float area2 = __fsub_rn(__fmul_rn(e01u, e02v), __fmul_rn(e01v, e02u));
  ok = ok && fabsf(area2) > s.eps_area;
  if (s.cull) {
    const float e1x = __fsub_rn(x[1], x[0]), e1y = __fsub_rn(y[1], y[0]),
                e1z = __fsub_rn(z[1], z[0]);
    const float e2x = __fsub_rn(x[2], x[0]), e2y = __fsub_rn(y[2], y[0]),
                e2z = __fsub_rn(z[2], z[0]);
    const float nx = __fsub_rn(__fmul_rn(e1y, e2z), __fmul_rn(e1z, e2y));
    const float ny = __fsub_rn(__fmul_rn(e1z, e2x), __fmul_rn(e1x, e2z));
    const float nz = __fsub_rn(__fmul_rn(e1x, e2y), __fmul_rn(e1y, e2x));
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(nx, x[0]), __fmul_rn(ny, y[0])),
                              __fmul_rn(nz, z[0]));
    ok = ok && d < 0.f;
  }
  const float w = ok ? 1.f : 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) fb[(c * 4 + 3) * F1 + f] = w;
  const float lox = nan_min(nan_min(u[0], u[1]), u[2]);
  const float hix = nan_max(nan_max(u[0], u[1]), u[2]);
  const float loy = nan_min(nan_min(v[0], v[1]), v[2]);
  const float hiy = nan_max(nan_max(v[0], v[1]), v[2]);
  const size_t i = (size_t)b * s.F + f, plane = (size_t)s.B * s.F;
  s.box[i] = __fsub_rn(lox, s.margin);
  s.box[plane + i] = __fsub_rn(loy, s.margin);
  s.box[2 * plane + i] = __fadd_rn(hix, s.margin);
  s.box[3 * plane + i] = __fadd_rn(hiy, s.margin);
  if (s.subsort) s.box[4 * plane + i] = __fmul_rn(0.5f, __fadd_rn(loy, hiy));
  s.valid[i] = ok;
}

struct Pack {
  const int* counts;             // [B, T] per-tile loads (min(total, cap))
  const unsigned char* bin_ovf;  // [B] the binner's overflow
  const int* idx;                // [B, T, cap] triangle of each slot (F = unused)
  const float* fields;           // [B, 12, F + 1]
  int* starts;                   // [B, T] first chunk of each tile
  float* rec;                    // [B, 12, nc * 128]
  int* nlive;                    // [B, nc]
  int* ctmap;                    // [B, nc]
  int* ncu;                      // [B]
  int* cpos;                     // [B, nc] the backward's identity map
  unsigned char* overflow;       // []
  int B, T, cap, F, nc;
};

// Exclusive block scan of v over SCAN_THREADS threads; *total gets the sum.
__device__ int block_scan(int v, int* total) {
  __shared__ int s_warp[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  __syncthreads();  // s_warp is free: the previous pass has read it
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < SCAN_THREADS / 32; ++w) {
    before += w < warp ? s_warp[w] : 0;
    sum += s_warp[w];
  }
  *total = sum;
  return before + incl - v;
}

// grid (B), SCAN_THREADS threads
__global__ void __launch_bounds__(SCAN_THREADS) compact_scan_kernel(Pack p) {
  __shared__ int s_last;
  const int b = blockIdx.x;
  const int* cnt = p.counts + (size_t)b * p.T;
  int* st = p.starts + (size_t)b * p.T;
  int* nl = p.nlive + (size_t)b * p.nc;
  int* ct = p.ctmap + (size_t)b * p.nc;
  if (threadIdx.x == 0) s_last = -1;
  int carry = 0, last = -1;
  for (int t0 = 0; t0 < p.T; t0 += SCAN_THREADS) {
    const int t = t0 + threadIdx.x;
    const int n = t < p.T ? (cnt[t] + CHUNK - 1) / CHUNK : 0;
    int total;
    const int ex = block_scan(n, &total);
    if (t < p.T) {
      const int c0 = carry + ex;
      st[t] = c0;
      for (int k = 0; k < n && c0 + k < p.nc; ++k) {  // the tile's chunks within the budget
        ct[c0 + k] = t;
        nl[c0 + k] = min(cnt[t] - k * CHUNK, CHUNK);
      }
      if (n > 0) last = t;
    }
    carry += total;
  }
  // The last non-empty tile: padding chunks continue it (the last tile on an
  // empty frame). Where ncu passes nc there is no padding.
  if (last >= 0) atomicMax(&s_last, last);
  __syncthreads();
  const int pad_tile = s_last >= 0 ? s_last : p.T - 1;
  for (int c = threadIdx.x; c < p.nc; c += SCAN_THREADS) {
    if (c >= carry) {
      ct[c] = pad_tile;
      nl[c] = 0;
    }
    p.cpos[(size_t)b * p.nc + c] = c;
  }
  if (threadIdx.x == 0) p.ncu[b] = carry;
}

// grid (nc, B), CHUNK threads
__global__ void __launch_bounds__(CHUNK) compact_gather_kernel(Pack p) {
  const int c = blockIdx.x, b = blockIdx.y, s = threadIdx.x;
  if (c == 0 && b == 0) {
    bool over = false;
    for (int i = s; i < p.B; i += CHUNK) over = over || p.bin_ovf[i] || p.ncu[i] > p.nc;
    over = __syncthreads_or(over);
    if (s == 0) *p.overflow = over;
  }
  const size_t cb = (size_t)b * p.nc + c;
  const int t = p.ctmap[cb];
  int f = p.F;  // the zero record
  if (s < p.nlive[cb]) {
    const int slot = (c - p.starts[(size_t)b * p.T + t]) * CHUNK + s;
    f = p.idx[((size_t)b * p.T + t) * p.cap + slot];
  }
  const size_t F1 = (size_t)p.F + 1, n = (size_t)p.nc * CHUNK;
  const float* fb = p.fields + (size_t)b * FIELDS * F1;
  float* out = p.rec + (size_t)b * FIELDS * n + (size_t)c * CHUNK + s;
  const bool live = f >= 0 && f < p.F;
#pragma unroll
  for (int i = 0; i < FIELDS; ++i) out[i * n] = live ? fb[i * F1 + f] : 0.f;
}

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// corners [3, 4, F] f32, link [F] i32, cam and base [B, L, 4, 4] f32, K [3, 3]
// f32 -> box [5, B, F] f32 (lox - m, loy - m, hix + m, hiy + m, suby; suby
// only with subsort), valid [B, F] bool, fields [B, 12, F + 1] f32. Returns the
// cudaError_t of the launch, 0 on success.
int easyhec_tri_setup(const float* corners, const int* link, const float* cam,
                      const float* base, const float* K, float* box, unsigned char* valid,
                      float* fields, int B, int F, int L, int subsort, int cull, float margin,
                      float near, float far, float eps_z, float eps_area, void* stream) {
  if (B <= 0 || B > 65535 || F <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const Setup s{corners, link, cam, base, K, box, valid, fields, B, F, L, subsort, cull,
                margin, near, far, eps_z, eps_area};
  tri_setup_kernel<<<dim3(cdiv(F, SETUP_THREADS), B), SETUP_THREADS, 0,
                     (cudaStream_t)stream>>>(s);
  return (int)cudaGetLastError();
}

// counts [B, T] i32, bin_ovf [B] bool, idx [B, T, cap] i32, fields
// [B, 12, F + 1] f32 -> rec [B, 12, nc * 128] f32, nlive, ctmap, cpos [B, nc]
// i32, ncu [B] i32, overflow [] bool, starts [B, T] i32 (each tile's first chunk). Returns
// the cudaError_t of the launches, 0 on success.
int easyhec_compact_pack(const int* counts, const unsigned char* bin_ovf, const int* idx,
                         const float* fields, int* starts, float* rec, int* nlive, int* ctmap,
                         int* ncu, int* cpos, unsigned char* overflow, int B, int T, int cap,
                         int F, int nc, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || cap <= 0 || F <= 0 || nc <= 0 ||
      (long long)T * cap >= 0x7fffffffLL || (long long)nc * CHUNK >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Pack p{counts, bin_ovf, idx, fields, starts, rec, nlive, ctmap, ncu, cpos, overflow,
               B, T, cap, F, nc};
  const auto s = (cudaStream_t)stream;
  compact_scan_kernel<<<B, SCAN_THREADS, 0, s>>>(p);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  compact_gather_kernel<<<dim3(nc, B), CHUNK, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
