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
// mins and a clamp. The backward's bound is bytes (the used chunks, acc and
// ref of the visited tiles: ~11 MB, 3.4 us at the bench start pose); its
// arithmetic is the same pairs on the live cotangent pixels only (the
// silhouette band under band_only, ~2.2 M pairs) plus a setup and a chain
// per slot. What holds it on the card is latency: short dependent chains of
// loads, a few live pixels per tile, and the heaviest tile's chunks.
//
// Forward design:
// - One block per (tile, frame, pixel sub-block), grid (T, B, S), one
//   thread per pixel. A sub-block holds at most 1024 pixels of its tile
//   (S = ceil(th*tw / 1024), 1 for the shipped 16x32 and 16x64 tiles), so
//   any tile size runs. The block walks the tile's ceil(count/128) chunks
//   itself, keeping acc in a register per pixel: no atomics, and every
//   output of every tile is written exactly once. Unvisited tiles (count 0)
//   still write acc = 0, the clipped image 0 and (K1f) Σ(0 - ref)² over the
//   crop. The loss is written per sub-block ([B, T, S]); the wrapper sums it
//   over S in a fixed order.
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
// Backward design (pose_raster_bwd.cuh): one block of 128 threads per
// (tile, frame), grid (T, B), one thread per slot of the chunk at hand; the
// block walks the tile's ceil(count/128) chunks. It compacts the tile's live
// cotangent pixels (K1b: 2·gb·e·1{acc<=1}·crop; K4b: g·1{acc<=1}; both
// ·1{0<acc<1} under band_only) into shared memory once; a tile with no slot
// or no live pixel writes zeros and exits. Each thread sets up its slot
// once (coalesced loads), culls it exactly, sweeps the list with its 13
// sums in registers and chains them to dTc itself: no per-triangle warp, no
// shuffles of the sums, no idle lanes, no spills. A fixed-order block sum
// writes parts[b, t, 0..11]; the wrapper sums over t in a fixed order. No
// float atomics anywhere. Splitting a tile's chunks over 2, 4 or 8 blocks
// was tried on an H100 and was no faster at the bench start pose: the extra
// blocks rebuild the live list, and most of them find no chunk.
// Not carried over from Pallas: the 8-row sub-block guards, the full-block
// ref stores, the (1,1) loss blocks and the MXU/factored reduction switch
// (EASYHEC_BWD_REDUCE), all Mosaic workarounds.

#include "pose_raster_bwd.cuh"

namespace {

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
// Backward: grid (T, B), BWD_THREADS threads, bwd_smem_bytes(th*tw) of
// dynamic shared memory; block (t, b) writes parts[b, t, 0..11]. kLoss: K1b
// (cotangent from ref and gb); else K4b (image cotangent gimg).
// --------------------------------------------------------------------------
template <bool kLoss>
__global__ void __launch_bounds__(BWD_THREADS) pose_bwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ cam,
    const float* __restrict__ rec, const float* __restrict__ acc_in,
    const float* __restrict__ ref, const float* __restrict__ gb,
    const float* __restrict__ gimg, float* __restrict__ parts, int T, int cap,
    int th, int tw, int n_tx, int H, int W, float sharp, float near,
    float far, int band_only) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int64_t tb = (int64_t)b * T + t;
  const int count = min(counts[tb], cap);
  const int64_t P = (int64_t)th * tw;
  const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);
  const int64_t S = (int64_t)T * cap;
  const float* rect = rec + (int64_t)b * REC * S + (int64_t)t * cap;
  float* out = parts + tb * REC;
  if constexpr (kLoss) {
    const LossCot cot{acc_in + tb * P, ref + tb * P, gb[b], x0, y0, tw, H, W,
                      band_only};
    tile_bwd(cot, rect, S, count, cam + (int64_t)b * 16, x0, y0, th, tw, sharp,
             near, far, out);
  } else {
    const ImageCot cot{acc_in + tb * P, gimg + tb * P, band_only};
    tile_bwd(cot, rect, S, count, cam + (int64_t)b * 16, x0, y0, th, tw, sharp,
             near, far, out);
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
// -> parts [B, T, 12].
extern "C" int easyhec_pose_bwd(int loss_mode, const int* counts,
                                const float* cam, const float* rec,
                                const float* acc, const float* ref,
                                const float* gb, const float* gimg,
                                float* parts, int B, int T, int cap, int th,
                                int tw, int n_tx, int H, int W, float sharp,
                                float near, float far, int band_only,
                                void* stream) {
  if (int err = check_dims(B, T, cap, th, tw)) return err;
  const int smem = bwd_smem_bytes(th * tw);
  const dim3 grid(T, B);
  if (loss_mode) {
    static int set = 0;
    if (int err = bwd_smem_limit(pose_bwd_kernel<true>, smem, set)) return err;
    pose_bwd_kernel<true><<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
        counts, cam, rec, acc, ref, gb, gimg, parts, T, cap, th, tw, n_tx, H,
        W, sharp, near, far, band_only);
  } else {
    static int set = 0;
    if (int err = bwd_smem_limit(pose_bwd_kernel<false>, smem, set)) return err;
    pose_bwd_kernel<false><<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
        counts, cam, rec, acc, ref, gb, gimg, parts, T, cap, th, tw, n_tx, H,
        W, sharp, near, far, band_only);
  }
  return (int)cudaGetLastError();
}
