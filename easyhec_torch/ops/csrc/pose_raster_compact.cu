// Compact-chunk fused mask-loss kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of easyhec_tpu/ops/pose_raster_compact.py:
//   loss_fwd_compact_kernel  <- _loss_fwd_kernel_compact (pallas_call :183)
//   loss_bwd_compact_kernel  <- _loss_bwd_kernel_compact (pallas_call :264)
// Plain PyTorch versions of both live in easyhec_torch/ops/pose_raster_compact.py
// (loss_fwd_compact_plain / loss_bwd_compact_plain); the math per chunk is
// easyhec_tpu/ops/pose_raster.py _chunk_setup / _chunk_coverage / _bwd_chunk.
//
// Records: rec [B, 12, nc*128] f32, field-major base-frame corner positions
// (x y z w per corner; all-zero = empty slot). cam [B, 16] = Tc[:3,:4]
// row-major | fx fy cx cy. Chunk c of frame b belongs to tile ctmap[b, c];
// the chunks of one tile are consecutive.
//
// What bounds them on an H100: neither moves many bytes (records, reference
// and acc tiles: tens of MB per call at the bench shapes, ~10 us at
// 3.35 TB/s). The forward is bound by FP32 operations: every (triangle lane,
// pixel) pair of every used chunk costs ~20 flops of edge functions, mins and
// a clamp. The backward does that work only where the masked cotangent is
// live (band pixels), plus a 13-way reduction per triangle.
//
// Design:
// - Blocks run in no order, so ONE BLOCK OWNS ONE TILE: the forward grid is
//   (nc, B) and only the block of a tile's first chunk proceeds; it walks the
//   tile's consecutive chunks itself, keeping acc in a register per pixel
//   (one thread per pixel). No atomics, no cross-block accumulation, and the
//   acc tile is written exactly once.
// - Per chunk, threads build the per-triangle setup (projection, validity,
//   normalized edges, poisoned bbox) into shared memory once; every pixel
//   thread then sweeps the chunk's live lanes from shared memory, so the
//   inner loop is pure FP32 arithmetic on broadcast operands.
// - The saturation early-out is a block vote (__syncthreads_and(acc >= 2)),
//   which changes only acc values >= 2, never clip(acc).
// - The per-tile loss is a fixed-order block reduction (deterministic).
// - Backward: one block per backward chunk, grid (ncb, B); each block writes
//   its own parts[b, c, 0..11], so again no atomics. The cotangent tile is
//   built once into shared memory; a block with no live pixel exits at once.
//   Then one warp per triangle: each thread covers P/32 pixels, the 13 pixel
//   sums are reduced by warp shuffle, and lane 0 chains them to the 12 dTc
//   terms. Warps sum their triangles in order, then the warps are summed in
//   order: the result does not depend on scheduling.
// Not carried over from Pallas: the full-block ref stores, the per-8-row
// sub-block guards (exact culls; a later change may add them back), the
// (1,1) loss blocks and the MXU/factored reduction switch.

#include "pose_raster_common.cuh"

namespace {

// --------------------------------------------------------------------------
// Forward: grid (nc, B), block = th*tw pixels rounded up to a warp multiple.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_THREADS) loss_fwd_compact_kernel(
    const int* __restrict__ nlive, const int* __restrict__ ctmap,
    const int* __restrict__ ncu, const float* __restrict__ cam,
    const float* __restrict__ rec, const float* __restrict__ ref,
    float* __restrict__ acc_out, float* __restrict__ loss_tiles, int nc,
    int T, int th, int tw, int n_tx, int H, int W, float sharp, float near,
    float far) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int* ct = ctmap + (int64_t)b * nc;
  const int t = ct[c];
  if (c > 0 && ct[c - 1] == t) return;  // not the first chunk of its tile

  __shared__ float s_e[9][CHUNK];    // a0 b0 c0 a1 b1 c1 a2 b2 c2
  __shared__ float s_box[4][CHUNK];  // lox loy hix hiy
  __shared__ float s_red[MAX_THREADS / 32];

  const int tid = threadIdx.x;
  const int P = th * tw;
  const bool active = tid < P;
  const int ix = tid % tw, iy = tid / tw;
  const float px = ix + 0.5f, py = iy + 0.5f;
  const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);
  const float* camb = cam + (int64_t)b * 16;
  const int64_t S = (int64_t)nc * CHUNK;
  const float* recb = rec + (int64_t)b * REC * S;

  float acc = 0.f;
  for (int cc = c; cc < nc && ct[cc] == t; ++cc) {
    const int nl = nlive[(int64_t)b * nc + cc];  // uniform over the block
    if (nl <= 0) continue;
    if (__syncthreads_and(!active || acc >= 2.f)) break;  // tile saturated
    for (int l = tid; l < nl; l += blockDim.x) {
      Lane L;
      lane_setup(recb + (int64_t)cc * CHUNK + l, S, camb, x0, y0, near, far, L);
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        s_e[3 * e][l] = L.a[e];
        s_e[3 * e + 1][l] = L.b[e];
        s_e[3 * e + 2][l] = L.c[e];
      }
      s_box[0][l] = L.lox;
      s_box[1][l] = L.loy;
      s_box[2][l] = L.hix;
      s_box[3][l] = L.hiy;
    }
    __syncthreads();
    for (int l = 0; l < nl; ++l) {
      const float d0 = s_e[0][l] * px + s_e[1][l] * py + s_e[2][l];
      const float d1 = s_e[3][l] * px + s_e[4][l] * py + s_e[5][l];
      const float d2 = s_e[6][l] * px + s_e[7][l] * py + s_e[8][l];
      const float dbb = fminf(fminf(px - s_box[0][l], s_box[2][l] - px),
                              fminf(py - s_box[1][l], s_box[3][l] - py));
      const float dmin = fminf(fminf(fminf(d0, d1), d2), dbb);
      acc += fminf(fmaxf(0.5f + sharp * dmin, 0.f), 1.f);
    }
    __syncthreads();  // the next chunk overwrites the setup
  }

  const int64_t tb = (int64_t)b * T + t;
  float sq = 0.f;
  if (active) {
    acc_out[tb * P + tid] = acc;
    const float e = fminf(fmaxf(acc, 0.f), 1.f) - ref[tb * P + tid];
    const bool in_img = (y0 + iy < H) && (x0 + ix < W);
    sq = in_img ? e * e : 0.f;
  }
  const float tot = block_sum(sq, s_red);
  if (tid == 0 && ncu[b] > 0) loss_tiles[tb] = tot;
}

// --------------------------------------------------------------------------
// Backward: grid (ncb, B), block = th*tw pixels rounded up to a warp multiple.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_THREADS) loss_bwd_compact_kernel(
    const int* __restrict__ bnl, const int* __restrict__ bct,
    const int* __restrict__ bcp, const float* __restrict__ cam,
    const float* __restrict__ gb, const float* __restrict__ rec,
    const float* __restrict__ ref, const float* __restrict__ acc_in,
    float* __restrict__ parts, int ncb, int nc, int T, int th, int tw,
    int n_tx, int H, int W, float sharp, float near, float far,
    int band_only) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int64_t bc = (int64_t)b * ncb + c;
  const int t = bct[bc], nl = bnl[bc], cp = bcp[bc];

  __shared__ float s_g[MAX_THREADS];
  __shared__ float s_part[MAX_THREADS / 32][REC];

  const int tid = threadIdx.x;
  const int P = th * tw;
  const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);
  const int64_t tb = (int64_t)b * T + t;

  // Masked cotangent 2·gb·e·1{acc<=1}·crop [·1{0<acc<1}].
  float g = 0.f;
  if (tid < P) {
    const float a = acc_in[tb * P + tid];
    const float e = fminf(fmaxf(a, 0.f), 1.f) - ref[tb * P + tid];
    g = 2.f * gb[b] * e * (a <= 1.f ? 1.f : 0.f);
    const bool in_img = (y0 + tid / tw < H) && (x0 + tid % tw < W);
    g = g * (in_img ? 1.f : 0.f);
    if (band_only) g = g * ((a > 0.f && a < 1.f) ? 1.f : 0.f);
    s_g[tid] = g;
  }
  const int live = __syncthreads_or(g != 0.f);
  float* out = parts + bc * REC;
  if (!live || nl <= 0) {
    if (tid < REC) out[tid] = 0.f;
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const float* camb = cam + (int64_t)b * 16;
  const float fx = camb[12], fy = camb[13];
  const int64_t S = (int64_t)nc * CHUNK;
  const float* slot0 = rec + (int64_t)b * REC * S + (int64_t)cp * CHUNK;

  float accw[REC];
#pragma unroll
  for (int k = 0; k < REC; ++k) accw[k] = 0.f;

  for (int l = warp; l < nl; l += nwarps) {
    Lane L;  // every thread of the warp sets up the same triangle
    lane_setup(slot0 + l, S, camb, x0, y0, near, far, L);
    if (!L.valid) continue;  // its terms are masked to zero (warp-uniform)
    // sums: [3e+0] Σg·px, [3e+1] Σg·py, [3e+2] Σg per edge arm e;
    //       [9] dlox, [10] dloy, [11] dhix, [12] dhiy for the bbox arm
    float s13[13];
#pragma unroll
    for (int k = 0; k < 13; ++k) s13[k] = 0.f;
    for (int p = lane; p < P; p += 32) {
      float gp = s_g[p];
      if (gp == 0.f) continue;
      const float px = (p % tw) + 0.5f, py = (p / tw) + 0.5f;
      const float d0 = L.a[0] * px + L.b[0] * py + L.c[0];
      const float d1 = L.a[1] * px + L.b[1] * py + L.c[1];
      const float d2 = L.a[2] * px + L.b[2] * py + L.c[2];
      const float dbb = fminf(fminf(px - L.lox, L.hix - px),
                              fminf(py - L.loy, L.hiy - py));
      const float dmin = fminf(fminf(fminf(d0, d1), d2), dbb);
      const float cov = fminf(fmaxf(0.5f + sharp * dmin, 0.f), 1.f);
      if (!(cov > 0.f && cov < 1.f)) continue;  // outside this triangle's band
      gp = gp * sharp;
      // first-match arm of the 4-way min
      int arm = 3;
      if (d0 <= dmin) arm = 0;
      else if (d1 <= dmin) arm = 1;
      else if (d2 <= dmin) arm = 2;
      if (arm < 3) {
        s13[3 * arm] += gp * px;
        s13[3 * arm + 1] += gp * py;
        s13[3 * arm + 2] += gp;
      } else if ((px - L.lox) <= dbb) {
        s13[9] -= gp;  // lox
      } else if ((L.hix - px) <= dbb) {
        s13[11] += gp;  // hix
      } else if ((py - L.loy) <= dbb) {
        s13[10] -= gp;  // loy
      } else {
        s13[12] += gp;  // hiy
      }
    }
#pragma unroll
    for (int k = 0; k < 13; ++k) s13[k] = warp_sum(s13[k]);
    if (lane != 0) continue;

    // chain: edge fields -> corner pixel coords (pose_raster.py _bwd_chunk)
    float du[3] = {0.f, 0.f, 0.f}, dv[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int ia = e, ib = (e + 1) % 3;
      const float da = s13[3 * e], db = s13[3 * e + 1], dc = s13[3 * e + 2];
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
    // bbox min/max: first matching corner takes the gradient
    const float dbox[4] = {s13[9], s13[10], s13[11], s13[12]};
    const float tgt[4] = {L.lox, L.loy, L.hix, L.hiy};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* vals = (k % 2 == 0) ? L.u : L.v;
      float* dvals = (k % 2 == 0) ? du : dv;
      if (vals[0] == tgt[k]) dvals[0] += dbox[k];
      else if (vals[1] == tgt[k]) dvals[1] += dbox[k];
      else if (vals[2] == tgt[k]) dvals[2] += dbox[k];
    }
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

  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < REC; ++k) s_part[warp][k] = accw[k];
  }
  __syncthreads();
  if (tid < REC) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += s_part[w][tid];
    out[tid] = s;
  }
}

}  // namespace

extern "C" int easyhec_loss_fwd_compact(
    const int* nlive, const int* ctmap, const int* ncu, const float* cam,
    const float* rec, const float* ref, float* acc, float* loss_tiles, int B,
    int nc, int T, int th, int tw, int n_tx, int H, int W, float sharp,
    float near, float far, void* stream) {
  const int P = th * tw;
  if (P <= 0 || P > MAX_THREADS || B <= 0 || B > 65535 || nc <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = (P + 31) / 32 * 32;
  loss_fwd_compact_kernel<<<dim3(nc, B), threads, 0, (cudaStream_t)stream>>>(
      nlive, ctmap, ncu, cam, rec, ref, acc, loss_tiles, nc, T, th, tw, n_tx,
      H, W, sharp, near, far);
  return (int)cudaGetLastError();
}

extern "C" int easyhec_loss_bwd_compact(
    const int* bnl, const int* bct, const int* bcp, const float* cam,
    const float* gb, const float* rec, const float* ref, const float* acc,
    float* parts, int B, int ncb, int nc, int T, int th, int tw, int n_tx,
    int H, int W, float sharp, float near, float far, int band_only,
    void* stream) {
  const int P = th * tw;
  if (P <= 0 || P > MAX_THREADS || B <= 0 || B > 65535 || ncb <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = (P + 31) / 32 * 32;
  loss_bwd_compact_kernel<<<dim3(ncb, B), threads, 0, (cudaStream_t)stream>>>(
      bnl, bct, bcp, cam, gb, rec, ref, acc, parts, ncb, nc, T, th, tw, n_tx,
      H, W, sharp, near, far, band_only);
  return (int)cudaGetLastError();
}
