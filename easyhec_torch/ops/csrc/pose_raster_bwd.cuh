// The fused mask-loss backward shared by K1b/K4b (pose_raster.cu,
// pose_bwd_kernel) and K2b (pose_raster_compact.cu,
// loss_bwd_compact_kernel): d(loss)/d(Tc[:3,:4]) of a run of record slots
// that all belong to one tile. The math is easyhec_tpu/ops/pose_raster.py
// _bwd_chunk (first-match subgradients of the 4-way min and of the bbox
// arms lox, hix, loy, hiy; the 13 pixel sums; the chain through the
// normalized edges, corner pixels and camera coordinates to 12 dTc terms);
// the plain PyTorch version is easyhec_torch/ops/pose_raster.py _bwd_chunk.
// K5b (tile_raster.cu, tile_bwd_kernel) shares steps 1 and 2 (the live list
// and the sweep into the 13 sums) and writes the sums in place of step 3.
//
// Layout of one block (BWD_THREADS threads):
// 1. The tile's live cotangent pixels (g != 0) are compacted, in pixel
//    order, into a list of float4 {px, py, g, 0} in dynamic shared memory
//    (ballot and a fixed-order prefix over the warps). A tile of more than
//    LIST_CAP pixels is swept in passes of LIST_CAP pixels; the sums carry
//    over from pass to pass in registers.
// 2. Thread l sets up slot l of the chunk once (coalesced field loads,
//    issued for the first chunk before the list is built, so that their
//    latency hides behind it), culls it with reaches_tile, and sweeps the
//    list from shared memory (broadcast reads), keeping the 13 sums in
//    registers. The arm is picked with selects, so nothing is indexed at
//    run time and nothing goes to local memory. The cotangent is loaded
//    four rounds of BWD_THREADS pixels at a time.
// 3. Each thread chains its own sums to 12 dTc terms; a block that walks
//    several chunks (a dense tile) adds them up per thread.
// 4. A fixed-order block sum (warp shuffle, then the warps in order) gives
//    one row of 12 partials per block. No float atomics: two launches on
//    the same inputs give bit-identical rows.
#pragma once

#include "pose_raster_common.cuh"

#define BWD_THREADS 128  // one thread per record slot of a chunk
#define BWD_WARPS (BWD_THREADS / 32)
#define LIST_CAP 4096  // live-list entries per pass (64 KB)

namespace {

// Whether a valid lane's coverage can be nonzero anywhere in a th x tw tile:
// cov > 0 needs every bbox distance above -0.5/sharpness (tile-local coords).
__device__ __forceinline__ bool reaches_tile(const Lane& L, int th, int tw,
                                             float reach) {
  return L.valid && L.hix + reach > 0.f && L.lox - reach < (float)tw &&
         L.hiy + reach > 0.f && L.loy - reach < (float)th;
}

// Dynamic shared memory of the backward for a tile of P pixels.
inline int bwd_smem_bytes(int P) {
  return (P < LIST_CAP ? P : LIST_CAP) * (int)sizeof(float4);
}

// Masked loss cotangent 2·gb·e·1{acc<=1}·crop [·1{0<acc<1}] of tile pixel p
// (_loss_bwd_kernel's gp2); acc and ref point at the tile.
struct LossCot {
  const float* acc;
  const float* ref;
  float gb, x0, y0;
  int tw, H, W, band_only;
  __device__ __forceinline__ float operator()(int p) const {
    const float a = acc[p];
    const float e = fminf(fmaxf(a, 0.f), 1.f) - ref[p];
    float g = 2.f * gb * e * (a <= 1.f ? 1.f : 0.f);
    const bool in_img = (y0 + p / tw < H) && (x0 + p % tw < W);
    g = g * (in_img ? 1.f : 0.f);
    if (band_only) g = g * ((a > 0.f && a < 1.f) ? 1.f : 0.f);
    return g;
  }
};

// Masked image cotangent g·1{acc<=1} [·1{0<acc<1}] (_masked_cotangent).
struct ImageCot {
  const float* acc;
  const float* gimg;
  int band_only;
  __device__ __forceinline__ float operator()(int p) const {
    const float a = acc[p];
    float g = gimg[p] * (a <= 1.f ? 1.f : 0.f);
    if (band_only) g = g * ((a > 0.f && a < 1.f) ? 1.f : 0.f);
    return g;
  }
};

// Compact the live cotangent pixels [p0, p0 + np) of the tile into s_list,
// in pixel order; returns their number (uniform over the block). Ends with a
// barrier, so the list is visible to every thread.
template <class Cot>
__device__ int build_live_list(const Cot& cot, int p0, int np, int tw,
                               float4* s_list, int (*s_wcnt)[BWD_WARPS]) {
  constexpr int kRounds = 4;  // rounds of BWD_THREADS pixels loaded at once
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int n = 0;
  for (int i0 = 0, it = 0; i0 < np; i0 += kRounds * BWD_THREADS) {
    float gr[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int k = i0 + r * BWD_THREADS + tid;
      gr[r] = k < np ? cot(p0 + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r, ++it) {
      if (i0 + r * BWD_THREADS >= np) break;  // uniform
      const float g = gr[r];
      const unsigned bal = __ballot_sync(0xffffffffu, g != 0.f);
      int* cnt = s_wcnt[it & 1];  // double-buffered: one barrier per round
      if (lane == 0) cnt[warp] = __popc(bal);
      __syncthreads();
      int off = n, tot = 0;
#pragma unroll
      for (int w = 0; w < BWD_WARPS; ++w) {
        const int c = cnt[w];
        off += (w < warp) ? c : 0;
        tot += c;
      }
      if (g != 0.f) {
        const int p = p0 + i0 + r * BWD_THREADS + tid;
        s_list[off + __popc(bal & ((1u << lane) - 1u))] =
            make_float4((p % tw) + 0.5f, (p / tw) + 0.5f, g, 0.f);
      }
      n += tot;
    }
  }
  __syncthreads();
  return n;
}

// The 13 pixel sums of one slot: per edge arm e, Σg·px, Σg·py, Σg; for the
// bbox arm, dlox, dloy, dhix, dhiy.
struct Sums13 {
  float ea[3], eb[3], ec[3];
  float lox, loy, hix, hiy;
};

// Sweep the live list [0, n) for slot L, adding into S; returns whether any
// pixel lay in the slot's band.
__device__ __forceinline__ bool sweep_list(const Lane& L,
                                           const float4* s_list, int n,
                                           float sharp, Sums13& S) {
  bool touched = false;
  for (int k = 0; k < n; ++k) {
    const float4 q = s_list[k];
    const float px = q.x, py = q.y;
    const float d0 = L.a[0] * px + L.b[0] * py + L.c[0];
    const float d1 = L.a[1] * px + L.b[1] * py + L.c[1];
    const float d2 = L.a[2] * px + L.b[2] * py + L.c[2];
    const float dbb = fminf(fminf(px - L.lox, L.hix - px),
                            fminf(py - L.loy, L.hiy - py));
    const float dmin = fminf(fminf(fminf(d0, d1), d2), dbb);
    const float cov = fminf(fmaxf(0.5f + sharp * dmin, 0.f), 1.f);
    if (!(cov > 0.f && cov < 1.f)) continue;  // outside this slot's band
    touched = true;
    const float gp = q.z * sharp;
    // first-match arm of the 4-way min, then of the bbox's four distances
    const bool m0 = d0 <= dmin;
    const bool m1 = !m0 && d1 <= dmin;
    const bool m2 = !m0 && !m1 && d2 <= dmin;
    const bool mb = !(m0 || m1 || m2);
    const bool xl = mb && (px - L.lox) <= dbb;
    const bool xh = mb && !xl && (L.hix - px) <= dbb;
    const bool yl = mb && !xl && !xh && (py - L.loy) <= dbb;
    const bool yh = mb && !xl && !xh && !yl;
    const float w0 = m0 ? gp : 0.f, w1 = m1 ? gp : 0.f, w2 = m2 ? gp : 0.f;
    S.ea[0] += w0 * px;
    S.eb[0] += w0 * py;
    S.ec[0] += w0;
    S.ea[1] += w1 * px;
    S.eb[1] += w1 * py;
    S.ec[1] += w1;
    S.ea[2] += w2 * px;
    S.eb[2] += w2 * py;
    S.ec[2] += w2;
    S.lox -= xl ? gp : 0.f;
    S.hix += xh ? gp : 0.f;
    S.loy -= yl ? gp : 0.f;
    S.hiy += yh ? gp : 0.f;
  }
  return touched;
}

// Chain the 13 sums of slot L to its 12 dTc terms and add them to accw
// (pose_raster.py _bwd_chunk).
__device__ __forceinline__ void chain_to_tc(const Lane& L, const Sums13& S,
                                            float fx, float fy,
                                            float (&accw)[REC]) {
  // edge fields -> corner pixel coords
  float du[3] = {0.f, 0.f, 0.f}, dv[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int ia = e, ib = (e + 1) % 3;
    const float da = S.ea[e], db = S.eb[e], dc = S.ec[e];
    const float da_t = da - dc * L.u[ia];
    const float db_t = db - dc * L.v[ia];
    du[ia] += -L.a[e] * dc;
    dv[ia] += -L.b[e] * dc;
    const float sdot = (da_t * L.p[e] + db_t * L.q[e]) / (L.n[e] * L.n[e]);
    const float dp = L.inv[e] * (da_t - sdot * L.p[e]);
    const float dq = L.inv[e] * (db_t - sdot * L.q[e]);
    dv[ia] += dp;
    dv[ib] -= dp;
    du[ib] += dq;
    du[ia] -= dq;
  }
  // bbox min/max: the first matching corner takes the gradient
  if (L.u[0] == L.lox) du[0] += S.lox;
  else if (L.u[1] == L.lox) du[1] += S.lox;
  else if (L.u[2] == L.lox) du[2] += S.lox;
  if (L.v[0] == L.loy) dv[0] += S.loy;
  else if (L.v[1] == L.loy) dv[1] += S.loy;
  else if (L.v[2] == L.loy) dv[2] += S.loy;
  if (L.u[0] == L.hix) du[0] += S.hix;
  else if (L.u[1] == L.hix) du[1] += S.hix;
  else if (L.u[2] == L.hix) du[2] += S.hix;
  if (L.v[0] == L.hiy) dv[0] += S.hiy;
  else if (L.v[1] == L.hiy) dv[1] += S.hiy;
  else if (L.v[2] == L.hiy) dv[2] += S.hiy;
  // pixel coords -> camera coords -> dTc[r, j] += dXc_r * Xb_j
  float dX[3][3];  // [corner][x y z]
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) {
    const float izs = 1.f / L.zc[ci];
    dX[ci][0] = du[ci] * fx * izs;
    dX[ci][1] = dv[ci] * fy * izs;
    dX[ci][2] = -(du[ci] * fx * L.xc[ci] + dv[ci] * fy * L.yc[ci]) * izs * izs;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      accw[4 * r + j] += dX[0][r] * L.X[j] + dX[1][r] * L.X[4 + j] +
                         dX[2][r] * L.X[8 + j];
}

// One block's backward: the slots [0, nslots) of the run at `slots` (field
// stride fstride), chunk by chunk, all in the tile at (x0, y0) whose masked
// cotangent is cot. Writes the block's 12 partials to out[0..11]. Call with
// BWD_THREADS threads and bwd_smem_bytes(th*tw) bytes of dynamic shared
// memory.
template <class Cot>
__device__ void tile_bwd(const Cot& cot, const float* __restrict__ slots,
                         int64_t fstride, int nslots,
                         const float* __restrict__ cam, float x0, float y0,
                         int th, int tw, float sharp, float near, float far,
                         float* __restrict__ out) {
  extern __shared__ float4 s_list[];
  __shared__ int s_wcnt[2][BWD_WARPS];
  __shared__ float s_red[BWD_WARPS][REC];

  const int tid = threadIdx.x;
  if (nslots <= 0) {  // no slot: uniform
    if (tid < REC) out[tid] = 0.f;
    return;
  }
  const int P = th * tw;
  const bool one_pass = P <= LIST_CAP;
  Lane L;
  // The first chunk's record loads are in flight while the list is built.
  if (tid < nslots) lane_load(slots + tid, fstride, L);
  int n = 0;
  if (one_pass) {
    n = build_live_list(cot, 0, P, tw, s_list, s_wcnt);
    if (n == 0) {  // no live pixel: uniform
      if (tid < REC) out[tid] = 0.f;
      return;
    }
  }

  const float fx = cam[12], fy = cam[13];
  const float reach = 0.5f / sharp + 1.f;
  float accw[REC];
#pragma unroll
  for (int k = 0; k < REC; ++k) accw[k] = 0.f;

  for (int j = 0; j * CHUNK < nslots; ++j) {
    const int s = j * CHUNK + tid;
    bool ok = false;
    if (s < nslots) {
      if (j > 0) lane_load(slots + s, fstride, L);
      lane_project(cam, x0, y0, near, far, L);
      ok = reaches_tile(L, th, tw, reach);
    }
    Sums13 S = {};
    bool touched = false;
    if (one_pass) {
      if (ok) touched = sweep_list(L, s_list, n, sharp, S);
    } else {
      for (int p0 = 0; p0 < P; p0 += LIST_CAP) {
        __syncthreads();  // every thread is done with the previous pass
        n = build_live_list(cot, p0, min(LIST_CAP, P - p0), tw, s_list, s_wcnt);
        if (ok) touched = sweep_list(L, s_list, n, sharp, S) || touched;
      }
    }
    if (touched) chain_to_tc(L, S, fx, fy, accw);
  }

  // Fixed-order block sum of the 12 partials.
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int k = 0; k < REC; ++k) {
    const float v = warp_sum(accw[k]);
    if (lane == 0) s_red[warp][k] = v;
  }
  __syncthreads();
  if (tid < REC) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) v += s_red[w][tid];
    out[tid] = v;
  }
}

// Raise a backward kernel's dynamic shared memory limit past the default
// 48 KB when a tile's live list needs it (at most LIST_CAP entries, 64 KB).
template <class Kernel>
int bwd_smem_limit(Kernel kernel, int smem, int& set) {
  if (smem + 1024 <= 48 * 1024 || smem <= set) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  set = smem;
  return 0;
}

}  // namespace
