// Per-tile soft-silhouette rasterizer for Hopper (sm_90a): the unfused route.
//
// Replaces the Pallas TPU kernels of easyhec_tpu/ops/tile_raster.py:
//   tile_fwd_kernel             <- _fwd_kernel (K5f, pallas_call :218)
//   tile_bwd_kernel<DenseOut>   <- _bwd_kernel (K5b, pallas_call :260)
//   tile_bwd_kernel<CountedOut>    the same, written through the transpose
//                                  of the record pack (render/binning.py)
// Plain PyTorch versions live in easyhec_torch/ops/tile_raster.py
// (tile_fwd_plain, tile_bwd_plain, tile_bwd_counted_plain), step by step the
// JAX arithmetic.
//
// Records: tri [B, T, 16, cap] f32, field-major tile-local edge records
//   rows [a0 b0 c0 a1 b1 c1 a2 b2 c2 lox loy hix hiy 0 0 0], slot on the last
//   axis; counts [B, T] int32 live slots per tile (slots at or beyond the
//   count are ignored). cap is a multiple of 128 (the wrapper pads).
// Per (pixel, slot): d_e = a_e px + b_e py + c_e, dbb = min(px - lox,
//   hix - px, py - loy, hiy - py), dmin = min(d0, d1, d2, dbb),
//   cov = clamp(0.5 + s dmin, 0, 1); acc = Σ_slots cov, out = clip(acc, 0, 1).
// Backward: gp = g · 1{acc <= 1} · 1{0 < cov < 1} · s per (pixel, slot); the
//   first matching arm of the 4-way min takes {gp px, gp py, gp} into the
//   rows of its edge (0-8), the bbox arm its first matching side, in the
//   order lox (row 9, -gp), hix (11, +gp), loy (10, -gp), hiy (12, +gp).
//
// What bounds them on an H100: a slot's coverage is exactly 0 outside its
// bbox dilated by the soft band 0.5/s, and at the bench shapes the slots span
// a pixel or two, so both kernels need few operations and are bound by bytes:
// the 13 fields of the live slots (the records, 639 MB at the bench shapes,
// are mostly empty slots that neither reads), the images, and the backward's
// output. The dense backward writes dtri everywhere (639 MB: that write is
// its bound); the counted one writes 13 floats per live slot only.
//
// Design:
// - Forward (pose_raster_fwd.cuh, as K1f/K4f): one resident wave of blocks
//   of 256 threads, grid (fwd_grid, B). The blocks of frame b list its
//   visited tiles (count > 0), heaviest first, and walk the (tile, 8x32
//   region) items; per region the tile's slots are loaded in passes of 512
//   (TileSlots: the 13 field rows, coalesced across threads, no setup),
//   culled against the region with the bbox dilated by the band, listed in
//   slot order in shared memory, and each warp adds for its 4x8 patch only
//   the records that reach it (a ballot per 32 records). The coverage rounds
//   op by op as the plain version's, so min(acc, 2) is the plain slot-order
//   sum bit for bit. Saturation early-out per warp and per block: only acc
//   values >= 2 change, never clip(acc) nor the backward's acc <= 1 mask.
//   Empty tiles are written (acc = 0, image 0) by warps.
// - Backward (pose_raster_bwd.cuh, as K1b/K4b): one block of 128 threads per
//   (tile, frame), grid (T, B), one thread per slot of the chunk at hand; the
//   block walks only the tile's used chunks, ceil(count/128). The live
//   cotangent pixels g·1{acc <= 1} are listed as float4 in shared memory
//   (passes of 4096 pixels); a tile with none skips the sweep. Each thread
//   loads its slot (coalesced), culls it (reaches_tile), sweeps the list
//   with its 13 sums in registers (sweep_list) and writes them itself: no
//   warp per slot, no shuffles, no float atomics, each output entry written
//   once by one thread, so two launches are bit-identical. Two epilogues:
//   DenseOut writes dtri [B, T, 16, cap] everywhere (zeros beyond the count
//   and in rows 13-15), the contract of tile_silhouette; CountedOut applies
//   the transpose of the record pack's tile-local shift (binning.py
//   _unshift_rows: da + dc·x0, db + dc·y0, dc; the bbox rows unchanged) and
//   writes the 13 rows of each slot below its count into dg [B, 13,
//   T·cap_bins + 1] at tile·cap_bins + slot, and nothing else: the pack's
//   gather at q reads only those entries (and the zero column the wrapper
//   sets).
// Not carried over from Pallas: the unrolled static chunk loop and the
// 64 MB scoped-VMEM limit (Mosaic workarounds).

#include "pose_raster_bwd.cuh"
#include "pose_raster_fwd.cuh"

#define TRI_REC 16
#define NFIELD 13

namespace {

// The edge and bbox fields of the slot at `slot` (field stride cap) into L,
// as tile_fwd and sweep_list read them: no setup.
__device__ __forceinline__ void k5_lane(const float* __restrict__ slot, int cap, Lane& L) {
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    L.a[e] = slot[(int64_t)(3 * e) * cap];
    L.b[e] = slot[(int64_t)(3 * e + 1) * cap];
    L.c[e] = slot[(int64_t)(3 * e + 2) * cap];
  }
  L.lox = slot[(int64_t)9 * cap];
  L.loy = slot[(int64_t)10 * cap];
  L.hix = slot[(int64_t)11 * cap];
  L.hiy = slot[(int64_t)12 * cap];
  L.valid = true;
}

// Slots [0, n) of one tile of tri: the 13 field rows, field stride cap.
struct TileSlots {
  const float* base;  // field 0 of slot 0 of the tile
  int cap;
  __device__ __forceinline__ bool setup(int i, Lane& L) const {
    k5_lane(base + i, cap, L);
    return true;
  }
};

// Slack of the backward's tile cull: coverage is nonzero only where every
// bbox distance exceeds -0.5/s; one more pixel absorbs rounding. sharpness
// <= 0 puts coverage outside the triangles too: no cull.
__device__ __forceinline__ float cull_reach(float sharp) {
  return sharp > 0.f ? 0.5f / sharp + 1.f : INFINITY;
}

// --------------------------------------------------------------------------
// Forward: grid (fwd_grid, B), FWD_THREADS threads. The blocks of frame b
// walk its visited tiles' regions (one per block at a time), then its empty
// tiles' regions (one per warp).
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS) tile_fwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ tri,
    float* __restrict__ out, float* __restrict__ acc_out, int T, int cap, int th,
    int tw, float sharp) {
  __shared__ int s_list[FWD_WINDOW], s_w[FWD_WINDOW], s_ord[FWD_WINDOW], s_tile;
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nsb = fwd_blocks(th, tw);
  const int* cnt = counts + (int64_t)b * T;
  const int64_t P = (int64_t)th * tw;
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
        const TileSlots src{tri + ((int64_t)b * T + t) * TRI_REC * cap, cap};
        acc = tile_fwd(src, min(cnt[t], cap), th, tw, fwd_pixel(j % nsb, tw, warp, lane),
                       sharp);
      }
      // Derived anew from s_tile and j: nothing held through the sweep.
      const int t = s_tile;
      __syncthreads();  // every thread has read s_tile before the next item sets it
      const FwdPixel f = fwd_pixel(j % nsb, tw, warp, lane);
      if (f.ix < tw && f.iy < th) {
        const int64_t pix = ((int64_t)b * T + t) * P + f.iy * tw + f.ix;
        acc_out[pix] = acc;
        out[pix] = fminf(fmaxf(acc, 0.f), 1.f);
      }
    }
    // Empty tiles: acc = 0 and the image 0, one region per warp, a lane per
    // column of it.
    for (int j = blockIdx.x * FWD_WARPS + warp; j < (nw - nvis) * nsb;
         j += gridDim.x * FWD_WARPS) {
      const int t = w0 + s_list[FWD_WINDOW - 1 - j / nsb], sb = j % nsb;
      const int n_rx = (tw + REGION_W - 1) / REGION_W;
      const int ix = (sb % n_rx) * REGION_W + lane, iy0 = (sb / n_rx) * REGION_H;
      const int rows = ix < tw ? min(REGION_H, th - iy0) : 0;
      const int64_t base = ((int64_t)b * T + t) * P + (int64_t)iy0 * tw + ix;
      for (int q = 0; q < rows; ++q) {
        acc_out[base + (int64_t)q * tw] = 0.f;
        out[base + (int64_t)q * tw] = 0.f;
      }
    }
    __syncthreads();  // the next window rewrites the list
  }
}

// --------------------------------------------------------------------------
// Backward epilogues: what a thread writes for slot s of tile t of frame b
// (tb = b*T + t), and what the block writes beyond the tile's count.
// --------------------------------------------------------------------------

// dtri [B, T, 16, cap]: every entry.
struct DenseOut {
  float* dtri;
  int cap;
  __device__ __forceinline__ void put(int64_t tb, int, int s, const Sums13& S) const {
    float* d = dtri + tb * TRI_REC * cap + s;
    const float row[NFIELD] = {S.ea[0], S.eb[0], S.ec[0], S.ea[1], S.eb[1], S.ec[1],
                               S.ea[2], S.eb[2], S.ec[2], S.lox, S.loy, S.hix, S.hiy};
#pragma unroll
    for (int f = 0; f < NFIELD; ++f) d[(int64_t)f * cap] = row[f];
  }
  // Zeros in rows 13-15 and beyond the count.
  __device__ __forceinline__ void rest(int64_t tb, int count) const {
    float* d = dtri + tb * TRI_REC * cap;
    for (int f = 0; f < TRI_REC; ++f)
      for (int s = (f < NFIELD ? count : 0) + threadIdx.x; s < cap; s += BWD_THREADS)
        d[(int64_t)f * cap + s] = 0.f;
  }
};

// dg [B, 13, T*cap_bins + 1]: the record pack's transpose of slot s of tile
// t, at t*cap_bins + s; nothing beyond the count.
struct CountedOut {
  float* dg;
  int T, cap_bins, n_tx, th, tw;
  __device__ __forceinline__ void put(int64_t tb, int t, int s, const Sums13& S) const {
    const int64_t row = (int64_t)T * cap_bins + 1;
    const int64_t b = tb / T;
    float* d = dg + b * NFIELD * row + (int64_t)t * cap_bins + s;
    const float x0 = (float)((t % n_tx) * tw), y0 = (float)((t / n_tx) * th);
#pragma unroll
    for (int e = 0; e < 3; ++e) {  // c' = c + a*x0 + b*y0
      d[(3 * e) * row] = __fadd_rn(S.ea[e], __fmul_rn(S.ec[e], x0));
      d[(3 * e + 1) * row] = __fadd_rn(S.eb[e], __fmul_rn(S.ec[e], y0));
      d[(3 * e + 2) * row] = S.ec[e];
    }
    d[9 * row] = S.lox;
    d[10 * row] = S.loy;
    d[11 * row] = S.hix;
    d[12 * row] = S.hiy;
  }
  __device__ __forceinline__ void rest(int64_t, int) const {}
};

// --------------------------------------------------------------------------
// Backward: grid (T, B), BWD_THREADS threads (one per slot of a chunk),
// bwd_smem_bytes(th*tw) of dynamic shared memory. lim caps the count: the
// kernel's cap (dense) or the bins' cap (counted).
// --------------------------------------------------------------------------
template <class Out>
__global__ void __launch_bounds__(BWD_THREADS) tile_bwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ tri,
    const float* __restrict__ acc_in, const float* __restrict__ gimg, Out out, int T,
    int cap, int lim, int th, int tw, float sharp) {
  extern __shared__ float4 s_list[];
  __shared__ int s_wcnt[2][BWD_WARPS];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int64_t tb = (int64_t)b * T + t;
  const int count = max(0, min(counts[tb], lim));
  const int P = th * tw;
  const float* rec = tri + tb * TRI_REC * cap;
  const ImageCot cot{acc_in + tb * P, gimg + tb * P, 0};
  const bool one_pass = P <= LIST_CAP;
  Lane L;
  // The first chunk's record loads are in flight while the list is built.
  if (tid < count) k5_lane(rec + tid, cap, L);
  int n = 0;
  bool live = count > 0;  // uniform
  if (live && one_pass) {
    n = build_live_list(cot, 0, P, tw, s_list, s_wcnt);
    live = n > 0;  // no live pixel: the sums stay zero
  }
  const float reach = cull_reach(sharp);
  for (int j = 0; j * CHUNK < count; ++j) {
    const int s = j * CHUNK + tid;
    Sums13 S = {};
    if (live) {
      bool ok = false;
      if (s < count) {
        if (j > 0) k5_lane(rec + s, cap, L);
        ok = reaches_tile(L, th, tw, reach);
      }
      if (one_pass) {
        if (ok) sweep_list(L, s_list, n, sharp, S);
      } else {
        for (int p0 = 0; p0 < P; p0 += LIST_CAP) {
          __syncthreads();  // every thread is done with the previous pass
          n = build_live_list(cot, p0, min(LIST_CAP, P - p0), tw, s_list, s_wcnt);
          if (ok) sweep_list(L, s_list, n, sharp, S);
        }
      }
    }
    if (s < count) out.put(tb, t, s, S);
  }
  out.rest(tb, count);
}

int check_dims(int B, int T, int cap, int th, int tw) {
  if (th <= 0 || tw <= 0 || B <= 0 || B > 65535 || T <= 0 || cap <= 0 ||
      cap % CHUNK != 0 || (int64_t)th * tw > 0x7fffffff ||
      (int64_t)T * fwd_blocks(th, tw) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// K5f: counts [B, T], tri [B, T, 16, cap] -> out = clip(acc), acc [B, T, th, tw].
extern "C" int easyhec_tile_fwd(const int* counts, const float* tri, float* out,
                                float* acc, int B, int T, int cap, int th,
                                int tw, float sharp, void* stream) {
  if (int err = check_dims(B, T, cap, th, tw)) return err;
  static int wave[FWD_MAX_DEVICES] = {};
  tile_fwd_kernel<<<dim3(fwd_grid(tile_fwd_kernel, B, wave), B), FWD_THREADS, 0,
                    (cudaStream_t)stream>>>(counts, tri, out, acc, T, cap, th, tw, sharp);
  return (int)cudaGetLastError();
}

// K5b: + acc, g [B, T, th, tw]. counted 0: -> dtri [B, T, 16, cap] (out);
// counted 1: -> dg [B, 13, T*cap_bins + 1] (out), the slots below each
// tile's count only, through the record pack's transpose (tiles of th x tw
// pixels, n_tx per row; cap_bins <= cap).
extern "C" int easyhec_tile_bwd(int counted, const int* counts, const float* tri,
                                const float* acc, const float* g, float* out, int B,
                                int T, int cap, int th, int tw, int n_tx, int cap_bins,
                                float sharp, void* stream) {
  if (int err = check_dims(B, T, cap, th, tw)) return err;
  const int smem = bwd_smem_bytes(th * tw);
  const dim3 grid(T, B);
  if (counted) {
    if (cap_bins <= 0 || cap_bins > cap || n_tx <= 0) return (int)cudaErrorInvalidValue;
    static int set = 0;
    if (int err = bwd_smem_limit(tile_bwd_kernel<CountedOut>, smem, set)) return err;
    tile_bwd_kernel<CountedOut><<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
        counts, tri, acc, g, CountedOut{out, T, cap_bins, n_tx, th, tw}, T, cap, cap_bins,
        th, tw, sharp);
  } else {
    static int set = 0;
    if (int err = bwd_smem_limit(tile_bwd_kernel<DenseOut>, smem, set)) return err;
    tile_bwd_kernel<DenseOut><<<grid, BWD_THREADS, smem, (cudaStream_t)stream>>>(
        counts, tri, acc, g, DenseOut{out, cap}, T, cap, cap, th, tw, sharp);
  }
  return (int)cudaGetLastError();
}
