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
// bench shapes), but a tile reads only its live slots, ~10 MB per call. The
// forward (pose_raster_fwd.cuh) needs only the lane-pixel pairs whose pixel
// centre lies in the lane's bbox dilated by the soft band 0.5/sharpness
// (every other pair has exactly zero coverage), 27 FP32 operations each
// (OPS_FWD_PAIR in chip_smoke.py): ~0.8 M pairs at the bench start pose, so
// its bound is bytes: the records of the live slots, ref in (K1f) or the
// image out (K4f), and acc out over every tile, ~34 MB. The backward's bound
// is bytes too (the used chunks, acc and ref of the visited tiles: ~11 MB,
// 3.4 us at the bench start pose); its arithmetic is the same pairs on the
// live cotangent pixels only (the silhouette band under band_only) plus a
// setup and a chain per slot. What holds both on the card is latency: short
// dependent chains of loads and barriers, and the heaviest tile's slots.
//
// Forward design (pose_raster_fwd.cuh): one resident wave of blocks of
// FWD_THREADS threads, grid (blocks per frame, B). The blocks of frame b list
// its visited tiles (count > 0), heaviest first, and walk the (tile, 8x32
// region) items in turn, one thread per pixel of the region: a block sets
// up the tile's slots [0, count) in passes of 512 (every thread, coalesced
// loads), culls each against the region exactly (band-dilated bbox), lists
// the survivors as float4 records in shared memory in slot order, and each
// warp adds, for its 4x8 patch, only the records whose dilated bbox reaches
// the patch (a ballot per 32 records): the ~99 % of pairs with exactly zero
// coverage are never evaluated, and acc is the plain version's slot-order
// sum bit for bit. Then each warp writes empty tiles' regions (acc = 0, the
// clipped image 0 and, K1f, Σ(0 - ref)² over the crop). The loss is a
// fixed-order sum per region ([B, T, fwd_blocks]); the wrapper sums it over
// the regions in a fixed order. The saturation early-out is a vote per warp
// and per block: it changes only acc values >= 2, never clip(acc), acc <= 1
// or 0 < acc < 1. No atomics.
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
// Not carried over from Pallas: the 8-row sub-block guards (the exact
// per-patch culls take their place), the full-block ref stores, the (1,1)
// loss blocks and the MXU/factored reduction switch (EASYHEC_BWD_REDUCE),
// all Mosaic workarounds.

#include "pose_raster_bwd.cuh"
#include "pose_raster_fwd.cuh"

namespace {

// --------------------------------------------------------------------------
// Forward: grid (fwd_grid, B), FWD_THREADS threads. The blocks of frame b
// walk its visited tiles' regions (one per block at a time), then its empty
// tiles' regions (one per warp). kLoss: K1f (loss_tiles and acc); else K4f
// (clip(acc) and acc).
// --------------------------------------------------------------------------
template <bool kLoss>
__global__ void __launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS) pose_fwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ cam,
    const float* __restrict__ rec, const float* __restrict__ ref,
    float* __restrict__ acc_out, float* __restrict__ sil_out,
    float* __restrict__ loss_tiles, int T, int cap, int th, int tw, int n_tx,
    int H, int W, float sharp, float near, float far) {
  __shared__ int s_list[FWD_WINDOW], s_w[FWD_WINDOW], s_ord[FWD_WINDOW], s_tile;
  __shared__ float s_red[FWD_WARPS], s_cam[16];
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < 16) s_cam[tid] = cam[(int64_t)b * 16 + tid];  // seen after split_list
  const int nsb = fwd_blocks(th, tw);
  const int* cnt = counts + (int64_t)b * T;
  const int64_t P = (int64_t)th * tw, S = (int64_t)T * cap;
  const float* recb = rec + (int64_t)b * REC * S;
  for (int w0 = 0; w0 < T; w0 += FWD_WINDOW) {
    const int nw = min(FWD_WINDOW, T - w0);
    const int nvis = split_list(nw, [&](int i) { return cnt[w0 + i] > 0; }, s_list);
    for (int i = tid; i < nvis; i += FWD_THREADS) s_w[i] = min(cnt[w0 + s_list[i]], cap);
    __syncthreads();
    order_by_weight(nvis, s_w, s_ord);
    const int items = nvis * nsb;
    for (int k = 0; k * (int)gridDim.x < items; ++k) {
      const int j = snake_item(k);
      if (j >= items) continue;  // uniform: the last round is partial
      float acc;
      {
        const int t = w0 + s_list[s_ord[j / nsb]];
        if (tid == 0) s_tile = t;  // read again after the sweep (its barriers)
        const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);
        const ProjectedSlots<DenseSlots> src{{recb + (int64_t)t * cap}, (int)S, s_cam,
                                             x0, y0, near, far};
        acc = tile_fwd(src, min(cnt[t], cap), th, tw, fwd_pixel(j % nsb, tw, warp, lane), sharp);
      }
      // Everything below is derived anew from s_tile and j, so that none of
      // it is held in registers through the sweep.
      const int t = s_tile, sb = j % nsb;
      __syncthreads();  // every thread has read s_tile before the next item sets it
      const int64_t tb = (int64_t)b * T + t;
      const FwdPixel f = fwd_pixel(sb, tw, warp, lane);
      const bool on = f.ix < tw && f.iy < th;
      const int64_t pix = tb * P + f.iy * tw + f.ix;
      const float clipped = fminf(fmaxf(acc, 0.f), 1.f);
      if (on) {
        acc_out[pix] = acc;
        if (!kLoss) sil_out[pix] = clipped;
      }
      if (kLoss) {
        const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);
        const float e = on ? clipped - ref[pix] : 0.f;
        const bool in_img = on && y0 + f.iy < H && x0 + f.ix < W;
        const float tot = block_sum(in_img ? e * e : 0.f, s_red);
        if (tid == 0) loss_tiles[tb * nsb + sb] = tot;
      }
    }
    // Empty tiles: acc = 0, the clipped image 0, and (K1f) Σ(0 - ref)² over
    // the crop, one region per warp, a lane per column of it.
    for (int j = blockIdx.x * FWD_WARPS + warp; j < (nw - nvis) * nsb;
         j += gridDim.x * FWD_WARPS) {
      const int t = w0 + s_list[FWD_WINDOW - 1 - j / nsb], sb = j % nsb;
      const int64_t tile = ((int64_t)b * T + t) * P;
      const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);
      const int n_rx = (tw + REGION_W - 1) / REGION_W;
      const int ix = (sb % n_rx) * REGION_W + lane, iy0 = (sb / n_rx) * REGION_H;
      const int rows = ix < tw ? min(REGION_H, th - iy0) : 0;
      float* acc_t = acc_out + tile + iy0 * tw + ix;
      for (int q = 0; q < rows; ++q) acc_t[q * tw] = 0.f;
      if (!kLoss) {
        float* sil_t = sil_out + tile + iy0 * tw + ix;
        for (int q = 0; q < rows; ++q) sil_t[q * tw] = 0.f;
      } else {
        const float* ref_t = ref + tile + iy0 * tw + ix;
        float r[REGION_H];
#pragma unroll
        for (int q = 0; q < REGION_H; ++q) r[q] = q < rows ? ref_t[q * tw] : 0.f;
        float sq = 0.f;
#pragma unroll
        for (int q = 0; q < REGION_H; ++q)
          sq += (y0 + iy0 + q < H && x0 + ix < W) ? r[q] * r[q] : 0.f;
        sq = warp_sum(sq);
        if (lane == 0) loss_tiles[((int64_t)b * T + t) * nsb + sb] = sq;
      }
    }
    __syncthreads();  // the next window rewrites the list
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
  if (th <= 0 || tw <= 0 || B <= 0 || B > 65535 || T <= 0 || cap <= 0 ||
      cap % CHUNK != 0 || (int64_t)T * cap > 0x7fffffff ||
      (int64_t)T * fwd_blocks(th, tw) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// loss_mode 1: K1f (ref -> loss_tiles [B, T, S], acc); 0: K4f (sil = clip(acc),
// acc). S = fwd_blocks(th, tw) regions of 8x32 pixels per tile.
extern "C" int easyhec_pose_fwd(int loss_mode, const int* counts,
                                const float* cam, const float* rec,
                                const float* ref, float* acc, float* sil,
                                float* loss_tiles, int B, int T, int cap,
                                int th, int tw, int n_tx, int H, int W,
                                float sharp, float near, float far,
                                void* stream) {
  if (int err = check_dims(B, T, cap, th, tw)) return err;
  if (loss_mode) {
    static int wave[FWD_MAX_DEVICES] = {};
    pose_fwd_kernel<true><<<dim3(fwd_grid(pose_fwd_kernel<true>, B, wave), B),
                            FWD_THREADS, 0, (cudaStream_t)stream>>>(
        counts, cam, rec, ref, acc, sil, loss_tiles, T, cap, th, tw, n_tx, H,
        W, sharp, near, far);
  } else {
    static int wave[FWD_MAX_DEVICES] = {};
    pose_fwd_kernel<false><<<dim3(fwd_grid(pose_fwd_kernel<false>, B, wave), B),
                             FWD_THREADS, 0, (cudaStream_t)stream>>>(
        counts, cam, rec, ref, acc, sil, loss_tiles, T, cap, th, tw, n_tx, H,
        W, sharp, near, far);
  }
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
