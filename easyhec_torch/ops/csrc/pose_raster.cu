// Dense-grid fused pose-raster kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of easyhec_tpu/ops/pose_raster.py:
//   pose_fwd_kernel<true>   <- _loss_fwd_kernel (K1f, pallas_call :762)
//   pose_bwd_kernel<true>   <- _loss_bwd_kernel (K1b, pallas_call :805)
//   pose_fwd_kernel<false>  <- _fwd_kernel      (K4f, pallas_call :558)
//   pose_bwd_kernel<false>  <- _bwd_kernel      (K4b, pallas_call :600)
// Plain PyTorch versions of all four live in easyhec_torch/ops/pose_raster.py
// (loss_fwd_plain, loss_bwd_plain, sil_fwd_plain, sil_bwd_plain); the math
// per chunk is _chunk_setup / _chunk_coverage / _bwd_chunk there.
//
// Records: rec [B, 12, T*cap] f32 (pose_raster_common.cuh); tile t of frame
// b owns slots [t*cap, t*cap + cap), of which the first counts[b, t] are
// live and the rest are all-zero sentinels. cap is a multiple of 128.
//
// What bounds them on an H100: the records are the big input (479 MB at the
// bench shapes), but a tile reads only its ceil(count/128) used chunks, tens
// of MB per call. The forward is bound by FP32 operations: every (triangle
// lane, pixel) pair of every used chunk costs ~27 flops of edge functions,
// mins and a clamp. The backward does that work only on the pixels whose
// masked cotangent is live (the silhouette band under band_only), plus a
// 13-way reduction and the chain to dTc per triangle.
//
// Design:
// - One block per (tile, frame, pixel sub-block), grid (T, B, S), one
//   thread per pixel. A sub-block holds at most 1024 pixels of its tile
//   (S = ceil(th*tw / 1024), 1 for the shipped 16x32 and 16x64 tiles), so
//   any tile size runs. The block walks the tile's ceil(count/128) chunks
//   itself, keeping acc in a register per pixel: no atomics, and every
//   output of every tile is written exactly once. Unvisited tiles (count 0)
//   still write acc = 0, the clipped image 0 and (K1f) Σ(0 - ref)² over the
//   crop. Loss and dTc partials are written per sub-block ([B, T, S] and
//   [B, T, S, 12]); the wrapper sums them over S in a fixed order.
// - Per chunk, threads set up the 128 lanes (projection, validity,
//   normalized edges, bbox) into shared memory once. A lane takes part only
//   if it is valid and its bbox, dilated by the soft band 0.5/sharpness and
//   one pixel of slack, reaches the tile: other lanes have exactly zero
//   coverage on every pixel of the tile, so skipping them is exact (the
//   Pallas kernel's row sub-block guards rest on the same fact).
// - The saturation early-out is a block vote (__syncthreads_and(acc >= 2))
//   over the sub-block, as in the compact kernel: it changes only acc values
//   >= 2, never clip(acc), acc <= 1 or 0 < acc < 1.
// - The per-tile loss is a fixed-order block reduction (deterministic).
// - Backward: the masked cotangent of the tile (K1b: 2·gb·e·1{acc<=1}·crop;
//   K4b: g·1{acc<=1}; both ·1{0<acc<1} under band_only) is compacted into a
//   list of live pixels in shared memory, in pixel order; a tile with none
//   writes zeros and exits. Then one warp per triangle: each thread takes
//   every 32nd live pixel, the 13 pixel sums are reduced by warp shuffle
//   (skipped when no thread of the warp touched the triangle's band), and
//   lane 0 chains them to the 12 dTc terms. Warps sum their triangles in
//   order, then the warps are summed in order into parts[b, t, s, 0..11];
//   the wrapper sums over s and t in a fixed order. No float atomics
//   anywhere.
// Not carried over from Pallas: the 8-row sub-block guards, the full-block
// ref stores, the (1,1) loss blocks and the MXU/factored reduction switch
// (EASYHEC_BWD_REDUCE), all Mosaic workarounds.

#include "pose_raster_common.cuh"

namespace {

// Whether a valid lane's coverage can be nonzero anywhere in a th x tw tile:
// cov > 0 needs every bbox distance above -0.5/sharpness (tile-local coords).
__device__ __forceinline__ bool reaches_tile(const Lane& L, int th, int tw,
                                             float reach) {
  return L.valid && L.hix + reach > 0.f && L.lox - reach < (float)tw &&
         L.hiy + reach > 0.f && L.loy - reach < (float)th;
}

// --------------------------------------------------------------------------
// Forward: grid (T, B, S), block = min(th*tw, 1024) pixels rounded up to a
// warp multiple. kLoss: K1f (loss_tiles and acc); else K4f (clip(acc) and
// acc).
// --------------------------------------------------------------------------
template <bool kLoss>
__global__ void __launch_bounds__(MAX_THREADS) pose_fwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ cam,
    const float* __restrict__ rec, const float* __restrict__ ref,
    float* __restrict__ acc_out, float* __restrict__ sil_out,
    float* __restrict__ loss_tiles, int T, int cap, int th, int tw, int n_tx,
    int H, int W, float sharp, float near, float far) {
  const int t = blockIdx.x, b = blockIdx.y, sb = blockIdx.z;
  const int64_t tb = (int64_t)b * T + t;
  const int count = min(counts[tb], cap);

  __shared__ float s_e[9][CHUNK];    // a0 b0 c0 a1 b1 c1 a2 b2 c2
  __shared__ float s_box[4][CHUNK];  // lox loy hix hiy
  __shared__ int s_ok[CHUNK];        // lane reaches the tile
  __shared__ float s_red[MAX_THREADS / 32];

  const int tid = threadIdx.x;
  const int P = th * tw;
  const int pix = sb * MAX_THREADS + tid;  // pixel of the tile
  const bool active = pix < P;
  const int ix = pix % tw, iy = pix / tw;
  const float px = ix + 0.5f, py = iy + 0.5f;
  const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);
  const float* camb = cam + (int64_t)b * 16;
  const int64_t S = (int64_t)T * cap;
  const float* rect = rec + (int64_t)b * REC * S + (int64_t)t * cap;
  const float reach = 0.5f / sharp + 1.f;

  float acc = 0.f;
  const int nch = (count + CHUNK - 1) / CHUNK;
  for (int j = 0; j < nch; ++j) {
    if (__syncthreads_and(!active || acc >= 2.f)) break;  // tile saturated
    for (int l = tid; l < CHUNK; l += blockDim.x) {
      Lane L;
      lane_setup(rect + (int64_t)j * CHUNK + l, S, camb, x0, y0, near, far, L);
      const bool ok = reaches_tile(L, th, tw, reach);
      s_ok[l] = ok;
      if (ok) {
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
    }
    __syncthreads();
    for (int l = 0; l < CHUNK; ++l) {
      if (!s_ok[l]) continue;  // uniform over the block
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

  const float clipped = fminf(fmaxf(acc, 0.f), 1.f);
  if (active) {
    acc_out[tb * P + pix] = acc;
    if (!kLoss) sil_out[tb * P + pix] = clipped;
  }
  if (kLoss) {
    float sq = 0.f;
    if (active) {
      const float e = clipped - ref[tb * P + pix];
      const bool in_img = (y0 + iy < H) && (x0 + ix < W);
      sq = in_img ? e * e : 0.f;
    }
    const float tot = block_sum(sq, s_red);
    if (tid == 0) loss_tiles[tb * gridDim.z + sb] = tot;
  }
}

// --------------------------------------------------------------------------
// Backward: grid (T, B, S), block = min(th*tw, 1024) pixels rounded up to a
// warp multiple. kLoss: K1b (cotangent from ref and gb); else K4b (image
// cotangent gimg).
// --------------------------------------------------------------------------
template <bool kLoss>
__global__ void __launch_bounds__(MAX_THREADS) pose_bwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ cam,
    const float* __restrict__ rec, const float* __restrict__ acc_in,
    const float* __restrict__ ref, const float* __restrict__ gb,
    const float* __restrict__ gimg, float* __restrict__ parts, int T, int cap,
    int th, int tw, int n_tx, int H, int W, float sharp, float near,
    float far, int band_only) {
  const int t = blockIdx.x, b = blockIdx.y, sb = blockIdx.z;
  const int64_t tb = (int64_t)b * T + t;
  const int count = min(counts[tb], cap);

  __shared__ float s_g[MAX_THREADS];  // live cotangent values, pixel order
  __shared__ int s_pix[MAX_THREADS];  // their pixel indices
  __shared__ int s_wcnt[MAX_THREADS / 32];
  __shared__ float s_part[MAX_THREADS / 32][REC];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int P = th * tw;
  const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);

  // Masked cotangent (_loss_bwd_kernel's gp2 / _masked_cotangent) of this
  // sub-block's pixels.
  const int pix = sb * MAX_THREADS + tid;
  float g = 0.f;
  if (pix < P) {
    const float a = acc_in[tb * P + pix];
    if (kLoss) {
      const float e = fminf(fmaxf(a, 0.f), 1.f) - ref[tb * P + pix];
      g = 2.f * gb[b] * e * (a <= 1.f ? 1.f : 0.f);
      const bool in_img = (y0 + pix / tw < H) && (x0 + pix % tw < W);
      g = g * (in_img ? 1.f : 0.f);
    } else {
      g = gimg[tb * P + pix] * (a <= 1.f ? 1.f : 0.f);
    }
    if (band_only) g = g * ((a > 0.f && a < 1.f) ? 1.f : 0.f);
  }
  // Compact the live pixels, in pixel order (deterministic).
  const unsigned bal = __ballot_sync(0xffffffffu, g != 0.f);
  if (lane == 0) s_wcnt[warp] = __popc(bal);
  __syncthreads();
  int off = 0, n_live = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int c = s_wcnt[w];
    off += (w < warp) ? c : 0;
    n_live += c;
  }
  if (g != 0.f) {
    const int pos = off + __popc(bal & ((1u << lane) - 1u));
    s_g[pos] = g;
    s_pix[pos] = pix;
  }
  __syncthreads();
  float* out = parts + (tb * gridDim.z + sb) * REC;
  if (n_live == 0 || count <= 0) {  // uniform over the block
    if (tid < REC) out[tid] = 0.f;
    return;
  }

  const float* camb = cam + (int64_t)b * 16;
  const float fx = camb[12], fy = camb[13];
  const int64_t S = (int64_t)T * cap;
  const float* rect = rec + (int64_t)b * REC * S + (int64_t)t * cap;
  const float reach = 0.5f / sharp + 1.f;
  const int nslots = (count + CHUNK - 1) / CHUNK * CHUNK;

  float accw[REC];
#pragma unroll
  for (int k = 0; k < REC; ++k) accw[k] = 0.f;

  for (int l = warp; l < nslots; l += nwarps) {
    Lane L;  // every thread of the warp sets up the same triangle
    lane_setup(rect + l, S, camb, x0, y0, near, far, L);
    if (!reaches_tile(L, th, tw, reach)) continue;  // warp-uniform
    // sums: [3e+0] Σg·px, [3e+1] Σg·py, [3e+2] Σg per edge arm e;
    //       [9] dlox, [10] dloy, [11] dhix, [12] dhiy for the bbox arm
    float s13[13];
#pragma unroll
    for (int k = 0; k < 13; ++k) s13[k] = 0.f;
    bool touched = false;
    for (int k = lane; k < n_live; k += 32) {
      const int p = s_pix[k];
      const float px = (p % tw) + 0.5f, py = (p / tw) + 0.5f;
      const float d0 = L.a[0] * px + L.b[0] * py + L.c[0];
      const float d1 = L.a[1] * px + L.b[1] * py + L.c[1];
      const float d2 = L.a[2] * px + L.b[2] * py + L.c[2];
      const float dbb = fminf(fminf(px - L.lox, L.hix - px),
                              fminf(py - L.loy, L.hiy - py));
      const float dmin = fminf(fminf(fminf(d0, d1), d2), dbb);
      const float cov = fminf(fmaxf(0.5f + sharp * dmin, 0.f), 1.f);
      if (!(cov > 0.f && cov < 1.f)) continue;  // outside this triangle's band
      touched = true;
      const float gp = s_g[k] * sharp;
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
    if (!__any_sync(0xffffffffu, touched)) continue;  // all sums are zero
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

int check_dims(int B, int T, int cap, int th, int tw) {
  const int P = th * tw;
  if (P <= 0 || B <= 0 || B > 65535 || T <= 0 || cap <= 0 || cap % CHUNK != 0 ||
      n_sub(P) > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// loss_mode 1: K1f (ref -> loss_tiles [B, T, S], acc); 0: K4f (sil = clip(acc),
// acc). S = ceil(th*tw / 1024) pixel sub-blocks per tile.
extern "C" int easyhec_pose_fwd(int loss_mode, const int* counts,
                                const float* cam, const float* rec,
                                const float* ref, float* acc, float* sil,
                                float* loss_tiles, int B, int T, int cap,
                                int th, int tw, int n_tx, int H, int W,
                                float sharp, float near, float far,
                                void* stream) {
  if (int err = check_dims(B, T, cap, th, tw)) return err;
  const int threads = sub_threads(th * tw);
  const dim3 grid(T, B, n_sub(th * tw));
  if (loss_mode)
    pose_fwd_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
        counts, cam, rec, ref, acc, sil, loss_tiles, T, cap, th, tw, n_tx, H,
        W, sharp, near, far);
  else
    pose_fwd_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
        counts, cam, rec, ref, acc, sil, loss_tiles, T, cap, th, tw, n_tx, H,
        W, sharp, near, far);
  return (int)cudaGetLastError();
}

// loss_mode 1: K1b (cotangent from ref, gb); 0: K4b (image cotangent gimg).
// -> parts [B, T, S, 12].
extern "C" int easyhec_pose_bwd(int loss_mode, const int* counts,
                                const float* cam, const float* rec,
                                const float* acc, const float* ref,
                                const float* gb, const float* gimg,
                                float* parts, int B, int T, int cap, int th,
                                int tw, int n_tx, int H, int W, float sharp,
                                float near, float far, int band_only,
                                void* stream) {
  if (int err = check_dims(B, T, cap, th, tw)) return err;
  const int threads = sub_threads(th * tw);
  const dim3 grid(T, B, n_sub(th * tw));
  if (loss_mode)
    pose_bwd_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
        counts, cam, rec, acc, ref, gb, gimg, parts, T, cap, th, tw, n_tx, H,
        W, sharp, near, far, band_only);
  else
    pose_bwd_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
        counts, cam, rec, acc, ref, gb, gimg, parts, T, cap, th, tw, n_tx, H,
        W, sharp, near, far, band_only);
  return (int)cudaGetLastError();
}
