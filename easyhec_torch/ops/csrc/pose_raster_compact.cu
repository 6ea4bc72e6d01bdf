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
// and acc tiles: tens of MB per call at the bench shapes, ~7 us at
// 3.35 TB/s). The forward (pose_raster_fwd.cuh) needs only the lane-pixel
// pairs whose pixel centre lies in the lane's bbox dilated by the soft band
// 0.5/sharpness (every other pair has exactly zero coverage), 27 FP32
// operations each (OPS_FWD_PAIR in chip_smoke.py): ~0.8 M pairs at the
// bench start pose, so bytes bound it too. The backward's bound is bytes
// (~11 MB, 3.3 us at the bench start pose): its pairs are only those on live
// cotangent pixels (the band under band_only), plus a setup and a chain per
// slot. What holds both on the card is latency: a block's chain of loads
// (map, cotangent tile, records) and barriers, and the heaviest tile's slots.
//
// Design:
// - Forward (pose_raster_fwd.cuh): blocks run in no order, so ONE BLOCK OWNS
//   ONE 8x32 REGION OF A TILE AT A TIME. The grid is one resident wave,
//   (blocks per frame, B); the blocks of frame b list the first chunks of
//   its tiles' runs (a chunk whose tile differs from its predecessor's,
//   below ncu: the rest are padding), heaviest run first, and walk the
//   (run, region) items in turn. Each item runs the shared forward over the
//   run's live slots: setup by every thread, an exact cull against the
//   region, a float4 list in shared memory, and per 4x8 warp patch only the
//   records whose band-dilated bbox reaches it, in slot order. No atomics,
//   no cross-block accumulation, and every pixel of a visited tile is
//   written exactly once; the wrapper's zero fill holds the unvisited tiles.
//   The loss is a fixed-order block sum per region, loss_tiles
//   [B, T, fwd_blocks], written only where ncu > 0; the wrapper sums over
//   the regions in a fixed order. The saturation early-out is a vote per
//   warp and per block, which changes only acc values >= 2, never clip(acc).
// - Backward (pose_raster_bwd.cuh): one block of 128 threads per backward
//   chunk, grid (ncb, B), one thread per slot. A padding chunk (nlive = 0)
//   writes zeros and exits before it reads the tile or the records. The block
//   compacts its tile's live cotangent pixels into shared memory once (a
//   tile with none writes zeros); each thread sets up its slot once
//   (coalesced loads), culls it exactly (reaches_tile), sweeps the list
//   with its 13 sums in registers and chains them to dTc itself; a
//   fixed-order block sum gives parts[b, c, 0..11]. Tiles of any size: the
//   list is swept in passes of at most 4096 pixels. No atomics.
// Not carried over from Pallas: the full-block ref stores, the per-8-row
// sub-block guards (exact culls take their place), the (1,1) loss blocks and
// the MXU/factored reduction switch.

#include "pose_raster_bwd.cuh"
#include "pose_raster_fwd.cuh"

namespace {

// --------------------------------------------------------------------------
// Forward: grid (fwd_grid, B), FWD_THREADS threads. The blocks of frame b
// walk the regions of the tiles its used chunks map to, one per block at a
// time; a tile's run of chunks starts at a chunk whose tile differs from its
// predecessor's and ends at the next such chunk (or at ncu).
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS) loss_fwd_compact_kernel(
    const int* __restrict__ nlive, const int* __restrict__ ctmap,
    const int* __restrict__ ncu, const float* __restrict__ cam,
    const float* __restrict__ rec, const float* __restrict__ ref,
    float* __restrict__ acc_out, float* __restrict__ loss_tiles, int nc,
    int T, int th, int tw, int n_tx, int H, int W, float sharp, float near,
    float far) {
  __shared__ int s_list[FWD_WINDOW], s_w[FWD_WINDOW], s_ord[FWD_WINDOW];
  __shared__ float s_red[FWD_WARPS], s_cam[16];
  __shared__ int s_end;
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < 16) s_cam[tid] = cam[(int64_t)b * 16 + tid];  // seen after split_list
  const int nsb = fwd_blocks(th, tw);
  const int* ct = ctmap + (int64_t)b * nc;
  const int used = min(ncu[b], nc);  // the chunks past ncu are padding
  const int64_t P = (int64_t)th * tw, S = (int64_t)nc * CHUNK;
  const float* recb = rec + (int64_t)b * REC * S;
  for (int w0 = 0; w0 < used; w0 += FWD_WINDOW) {
    const int nw = min(FWD_WINDOW, used - w0);
    const int nvis = split_list(nw, [&](int i) {
      const int c = w0 + i;
      return c == 0 || ct[c - 1] != ct[c];
    }, s_list);
    for (int i = tid; i < nvis; i += FWD_THREADS)  // chunks in the run (in the window)
      s_w[i] = (i + 1 < nvis ? s_list[i + 1] : nw) - s_list[i];
    __syncthreads();
    order_by_weight(nvis, s_w, s_ord);
    const int items = nvis * nsb;
    for (int k = 0; k * (int)gridDim.x < items; ++k) {
      const int j = snake_item(k);
      if (j >= items) continue;  // uniform: the last round is partial
      const int v = s_ord[j / nsb], sb = j % nsb;
      const int c = w0 + s_list[v], t = ct[c];
      int end = w0 + (v + 1 < nvis ? s_list[v + 1] : nw);
      if (v + 1 == nvis && end < used) {  // the run may go on past the window
        if (warp == 0) {
          int e = used;
          for (int base = end; base < used; base += 32) {
            const int cc = base + lane;
            const unsigned bal = __ballot_sync(0xffffffffu, cc < used && ct[cc] != t);
            if (bal) {
              e = base + __ffs(bal) - 1;
              break;
            }
          }
          if (lane == 0) s_end = e;
        }
        __syncthreads();
        end = s_end;
      }
      const int64_t tb = (int64_t)b * T + t;
      const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);
      const FwdPixel f = fwd_pixel(sb, tw, warp, lane);
      const ProjectedSlots<CompactSlots> src{
          {recb + (int64_t)c * CHUNK, nlive + (int64_t)b * nc + c}, (int)S, s_cam, x0, y0,
          near, far};
      const float acc = tile_fwd(src, (end - c) * CHUNK, th, tw, f, sharp);
      const bool on = f.ix < tw && f.iy < th;
      const int64_t pix = tb * P + f.iy * tw + f.ix;
      if (on) acc_out[pix] = acc;
      const float e = on ? fminf(fmaxf(acc, 0.f), 1.f) - ref[pix] : 0.f;
      const bool in_img = on && y0 + f.iy < H && x0 + f.ix < W;
      const float tot = block_sum(in_img ? e * e : 0.f, s_red);
      if (tid == 0) loss_tiles[tb * nsb + sb] = tot;  // ncu > 0 here
    }
    __syncthreads();  // the next window rewrites the list
  }
}

// --------------------------------------------------------------------------
// Backward: grid (ncb, B), BWD_THREADS threads (one per slot of the chunk),
// bwd_smem_bytes(th*tw) of dynamic shared memory; block (c, b) writes
// parts[b, c, 0..11].
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(BWD_THREADS) loss_bwd_compact_kernel(
    const int* __restrict__ bnl, const int* __restrict__ bct,
    const int* __restrict__ bcp, const float* __restrict__ cam,
    const float* __restrict__ gb, const float* __restrict__ rec,
    const float* __restrict__ ref, const float* __restrict__ acc_in,
    float* __restrict__ parts, int ncb, int nc, int T, int th, int tw,
    int n_tx, int H, int W, float sharp, float near, float far,
    int band_only) {
  const int c = blockIdx.x, b = blockIdx.y;
  const int64_t bc = (int64_t)b * ncb + c;
  const int t = bct[bc], nl = min(bnl[bc], CHUNK), cp = bcp[bc];
  const int64_t P = (int64_t)th * tw;
  const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);
  const int64_t tb = (int64_t)b * T + t;
  const int64_t S = (int64_t)nc * CHUNK;
  const LossCot cot{acc_in + tb * P, ref + tb * P, gb[b], x0, y0, tw, H, W,
                    band_only};
  tile_bwd(cot, rec + (int64_t)b * REC * S + (int64_t)cp * CHUNK, S, nl,
           cam + (int64_t)b * 16, x0, y0, th, tw, sharp, near, far,
           parts + bc * REC);
}

}  // namespace

extern "C" int easyhec_loss_fwd_compact(
    const int* nlive, const int* ctmap, const int* ncu, const float* cam,
    const float* rec, const float* ref, float* acc, float* loss_tiles, int B,
    int nc, int T, int th, int tw, int n_tx, int H, int W, float sharp,
    float near, float far, void* stream) {
  if (th <= 0 || tw <= 0 || B <= 0 || B > 65535 || nc <= 0 ||
      (int64_t)nc * CHUNK > 0x7fffffff ||
      (int64_t)FWD_WINDOW * fwd_blocks(th, tw) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  static int wave[FWD_MAX_DEVICES] = {};
  loss_fwd_compact_kernel<<<dim3(fwd_grid(loss_fwd_compact_kernel, B, wave), B),
                            FWD_THREADS, 0, (cudaStream_t)stream>>>(
      nlive, ctmap, ncu, cam, rec, ref, acc, loss_tiles, nc, T, th, tw, n_tx,
      H, W, sharp, near, far);
  return (int)cudaGetLastError();
}

// -> parts [B, ncb, 12], one row per backward chunk.
extern "C" int easyhec_loss_bwd_compact(
    const int* bnl, const int* bct, const int* bcp, const float* cam,
    const float* gb, const float* rec, const float* ref, const float* acc,
    float* parts, int B, int ncb, int nc, int T, int th, int tw, int n_tx,
    int H, int W, float sharp, float near, float far, int band_only,
    void* stream) {
  const int P = th * tw;
  if (P <= 0 || B <= 0 || B > 65535 || ncb <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = bwd_smem_bytes(P);
  static int set = 0;
  if (int err = bwd_smem_limit(loss_bwd_compact_kernel, smem, set)) return err;
  loss_bwd_compact_kernel<<<dim3(ncb, B), BWD_THREADS, smem,
                            (cudaStream_t)stream>>>(
      bnl, bct, bcp, cam, gb, rec, ref, acc, parts, ncb, nc, T, th, tw, n_tx,
      H, W, sharp, near, far, band_only);
  return (int)cudaGetLastError();
}
