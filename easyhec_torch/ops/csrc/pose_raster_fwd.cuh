// The coverage forward shared by K1f/K4f (pose_raster.cu, pose_fwd_kernel),
// K2f/K3 (pose_raster_compact.cu, loss_fwd_compact_kernel) and K5f
// (tile_raster.cu, tile_fwd_kernel): the raw coverage acc of one pixel of a
// tile, summed over the tile's record slots in slot order. The fused
// kernels set each slot up from base-frame corners (ProjectedSlots, the math
// of easyhec_tpu/ops/pose_raster.py _chunk_setup); K5f reads tile-local
// edge records as they are. The coverage is _chunk_coverage of
// easyhec_tpu/ops/pose_raster.py and tile_raster.py; the plain PyTorch
// versions are easyhec_torch/ops/pose_raster.py _chunk_setup and
// _chunk_coverage, and easyhec_torch/ops/tile_raster.py _chunk_coverage.
//
// What bounds it on an H100: a slot's soft coverage is exactly 0 at every
// pixel centre outside its bbox dilated by the soft band 0.5/sharpness
// (cov > 0 needs every bbox distance above -0.5/sharpness). The work that
// the data needs is the pairs inside those boxes, at 27 FP32 operations
// each (3 edge functions of 2 products and 2 sums, 4 bbox distances and 3
// mins, the 4-way min, the scaled clamp, the accumulate: OPS_FWD_PAIR in
// chip_smoke.py), plus a setup per slot. At the bench start pose the slots
// span a pixel or two, and that is ~0.8 M pairs against ~80 M whole-tile
// pairs: far too few operations to matter, so the bytes bound it (the
// records of the live slots, the reference, acc: tens of MB). What holds it
// on the card is latency: a tile's chain of loads, setup and barriers, and,
// on the dense route, the thousands of empty tiles, each a small write.
//
// Layout (FWD_THREADS threads, one pixel each):
// 1. The grid is one resident wave, (blocks per frame, B). Each block lists
//    its frame's tiles (or, compact, its tiles' first chunks) FWD_WINDOW at
//    a time, visited ones first (split_list), orders the visited ones
//    heaviest first (order_by_weight) and walks the (tile, region) items in
//    snake order over the frame's blocks (snake_item), so the heavy tiles
//    start first and spread. A region is REGION_H x REGION_W pixels of the
//    tile (clipped to it), so a heavy tile runs on several SMs and any tile
//    size runs; each warp owns one PATCH_H x PATCH_W patch of it. Every
//    pixel belongs to exactly one item: no cross-block sums, no atomics. On
//    the dense route and in K5f each warp then writes empty regions on its
//    own (acc = 0, and a warp sum of ref² or the image's 0).
// 2. For a region, the block walks the tile's slots in passes of FWD_PASS.
//    Every thread loads one slot's record a round through the kernel's
//    policy (coalesced field loads; the fused kernels set it up), culls it
//    exactly against the region's pixel centres dilated by the band, and
//    the survivors are compacted, in slot order, into a list of float4
//    records in shared memory: the three edges {a, b, c} and the bbox
//    {lox, loy, hix, hiy}, 4 vector loads a record.
// 3. Each warp sweeps the list in groups of 32: each thread tests one
//    record's dilated bbox against the warp's patch, a ballot collects the
//    hits, and the warp visits only those, in slot order, each thread
//    adding the record's coverage at its own pixel. A skipped pair has
//    exactly zero coverage, and adding zero leaves acc bit for bit as it
//    was; with the setup and the per-pixel expression rounded op by op as
//    the plain version's (lane_project, coverage), acc is the plain
//    version's slot-order sum bit for bit.
// 4. Saturation early-out: a warp stops when all its pixels hold acc >= 2,
//    the block when all its warps do. Only acc values >= 2 change: clip(acc),
//    acc <= 1 and 0 < acc < 1 are exact.
#pragma once

#include "pose_raster_common.cuh"

#define FWD_THREADS 256
#define FWD_WARPS (FWD_THREADS / 32)
#define PATCH_H 4  // a warp's patch: 4 x 8 pixels, one per thread
#define PATCH_W 8
#define REGION_PY 2  // a block's region: 2 x 4 patches = 8 x 32 pixels
#define REGION_PX 4
#define REGION_H (PATCH_H * REGION_PY)
#define REGION_W (PATCH_W * REGION_PX)
#define FWD_PASS 512  // slots set up per pass (list capacity: 32 KB)
#define FWD_MIN_BLOCKS 3  // resident blocks per SM: at most 80 registers
#define FWD_WINDOW 1024   // tiles (or chunks) of a frame listed at a time

namespace {

// Band slack, in pixels, above 0.5/sharpness: a cull against pixel centres
// must not drop a slot whose rounded coverage is above 0 (tile-local
// coordinates round by ~1e-5 px).
constexpr float kBandSlack = 1e-3f;

// Regions per tile: the forward's items, and loss partials, per tile.
__host__ __device__ inline int fwd_blocks(int th, int tw) {
  return ((th + REGION_H - 1) / REGION_H) * ((tw + REGION_W - 1) / REGION_W);
}

// A rectangle of pixel centres, tile-local: [x0, x1] x [y0, y1].
struct Box {
  float x0, x1, y0, y1;
};

// Whether a bbox {lox, loy, hix, hiy} dilated by `band` holds a pixel
// centre of box q (strict: cov > 0 needs a bbox distance above -band).
__device__ __forceinline__ bool reaches(float4 bb, const Box& q, float band) {
  return bb.z + band > q.x0 && bb.x - band < q.x1 && bb.w + band > q.y0 &&
         bb.y - band < q.y1;
}

// The tile-local pixel of lane l of warp w in region sb of a tile tw
// pixels wide. Regions and patches are aligned to their own sizes in the
// tile, so a pixel's patch and region follow from it (aligned_box).
struct FwdPixel {
  int ix, iy;
};

__device__ __forceinline__ FwdPixel fwd_pixel(int sb, int tw, int w, int l) {
  const int n_rx = (tw + REGION_W - 1) / REGION_W;
  return {(sb % n_rx) * REGION_W + (w % REGION_PX) * PATCH_W + l % PATCH_W,
          (sb / n_rx) * REGION_H + (w / REGION_PX) * PATCH_H + l / PATCH_W};
}

// The pixel centres of the h x w block aligned to multiples of (h, w) that
// holds pixel f, clipped to the th x tw tile: its warp's patch or its
// block's region (empty for a patch past the tile's edge).
__device__ __forceinline__ Box aligned_box(FwdPixel f, int h, int w, int th, int tw) {
  const int x0 = f.ix - f.ix % w, y0 = f.iy - f.iy % h;
  return {x0 + 0.5f, min(x0 + w, tw) - 0.5f, y0 + 0.5f, min(y0 + h, th) - 0.5f};
}

// Soft coverage of one record at pixel centre (px, py), each product and
// sum rounded on its own in the plain version's order (_chunk_coverage).
__device__ __forceinline__ float coverage(float4 e0, float4 e1, float4 e2,
                                          float4 bb, float px, float py,
                                          float sharp) {
  const float d0 = __fadd_rn(__fadd_rn(__fmul_rn(e0.x, px), __fmul_rn(e0.y, py)), e0.z);
  const float d1 = __fadd_rn(__fadd_rn(__fmul_rn(e1.x, px), __fmul_rn(e1.y, py)), e1.z);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(e2.x, px), __fmul_rn(e2.y, py)), e2.z);
  const float dbb = fminf(fminf(px - bb.x, bb.z - px), fminf(py - bb.y, bb.w - py));
  const float dmin = fminf(fminf(fminf(d0, d1), d2), dbb);
  return fminf(fmaxf(__fadd_rn(0.5f, __fmul_rn(sharp, dmin)), 0.f), 1.f);
}

// Slots [0, n) of a dense tile: contiguous, all live.
struct DenseSlots {
  const float* base;  // field 0 of slot 0
  __device__ __forceinline__ const float* slot(int i) const { return base + i; }
  __device__ __forceinline__ bool live(int) const { return true; }
};

// Slots of a run of compact chunks: contiguous, slot i live below its
// chunk's nlive (the slots past it are all-zero sentinels, safe to load).
struct CompactSlots {
  const float* base;  // field 0 of the run's first slot
  const int* nlive;   // of the run's first chunk
  __device__ __forceinline__ const float* slot(int i) const { return base + i; }
  __device__ __forceinline__ bool live(int i) const {
    return (i & (CHUNK - 1)) < nlive[i / CHUNK];
  }
};

// The fused kernels' records: base-frame corners of `src` (field stride
// fstride), set up through the frame's camera into the tile at (x0, y0).
// cam is the frame's camera row in shared memory: read at each setup, not
// held in registers. setup(i, L) fills L's edges and bbox, tile-local, and
// is false for a dead or invalid slot.
template <class Slots>
struct ProjectedSlots {
  Slots src;
  int fstride;
  const float* cam;
  float x0, y0, near, far;
  __device__ __forceinline__ bool setup(int i, Lane& L) const {
    lane_load(src.slot(i), fstride, L);  // the record and its liveness load together
    if (!src.live(i)) return false;
    lane_project(cam, x0, y0, near, far, L);
    return L.valid;
  }
};

// The soft band of a cull: coverage is 0 unless every bbox distance is
// above -0.5/sharpness; sharpness <= 0 puts coverage everywhere (no cull).
__device__ __forceinline__ float cull_band(float sharp) {
  return sharp > 0.f ? 0.5f / sharp + kBandSlack : INFINITY;
}

// Raw coverage acc at this thread's pixel f of the th x tw tile over the
// slots [0, n) of `src`, whose setup(i, L) gives slot i's tile-local edges
// L.a, L.b, L.c and bbox L.lox, L.loy, L.hix, L.hiy (false: the slot adds
// nothing). Call with FWD_THREADS threads, all of
// them; n and the tile are uniform over the block.
template <class Src>
__device__ float tile_fwd(const Src& src, int n, int th, int tw, FwdPixel f, float sharp) {
  __shared__ float4 s_e[3][FWD_PASS];
  __shared__ float4 s_box[FWD_PASS];
  __shared__ int s_wcnt[2][FWD_WARPS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float band = cull_band(sharp);
  const float px = f.ix + 0.5f, py = f.iy + 0.5f;
  const bool active = f.ix < tw && f.iy < th;
  float acc = 0.f;
  for (int p0 = 0, it = 0; p0 < n; p0 += FWD_PASS) {
    // the previous pass's list is swept; stop once every pixel saturated
    if (p0 > 0 && __syncthreads_and(!active || acc >= 2.f)) break;
    int m = 0;  // list entries of this pass
    for (int r = 0; r < FWD_PASS / FWD_THREADS; ++r, ++it) {
      const int i = p0 + r * FWD_THREADS + tid;
      Lane L;
      bool ok = i < n && src.setup(i, L);
      ok = ok && reaches(make_float4(L.lox, L.loy, L.hix, L.hiy),
                         aligned_box(f, REGION_H, REGION_W, th, tw), band);
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      int* cnt = s_wcnt[it & 1];  // double-buffered: one barrier per round
      if (lane == 0) cnt[warp] = __popc(bal);
      __syncthreads();
      int off = m, tot = 0;
#pragma unroll
      for (int w = 0; w < FWD_WARPS; ++w) {
        const int c = cnt[w];
        off += (w < warp) ? c : 0;
        tot += c;
      }
      if (ok) {
        const int k = off + __popc(bal & ((1u << lane) - 1u));
#pragma unroll
        for (int e = 0; e < 3; ++e) s_e[e][k] = make_float4(L.a[e], L.b[e], L.c[e], 0.f);
        s_box[k] = make_float4(L.lox, L.loy, L.hix, L.hiy);
      }
      m += tot;
      if (p0 + (r + 1) * FWD_THREADS >= n) break;  // uniform
    }
    __syncthreads();  // the list is complete
    for (int g = 0; g < m; g += 32) {
      if (__all_sync(0xffffffffu, !active || acc >= 2.f)) break;  // patch saturated
      const int k = g + lane;
      unsigned hits = __ballot_sync(
          0xffffffffu, k < m && reaches(s_box[k], aligned_box(f, PATCH_H, PATCH_W, th, tw), band));
      while (hits) {  // uniform over the warp
        const int j = g + __ffs(hits) - 1;
        hits &= hits - 1u;
        acc += coverage(s_e[0][j], s_e[1][j], s_e[2][j], s_box[j], px, py, sharp);
      }
    }
  }
  return acc;
}

// Stable split of the indices [0, n) (n <= FWD_WINDOW) by pred: those it
// holds go to s_list[0, k) in order, the others to s_list[FWD_WINDOW - 1]
// downwards in order; returns k. Call with all FWD_THREADS threads; ends
// with a barrier.
template <class Pred>
__device__ int split_list(int n, const Pred& pred, int* s_list) {
  __shared__ int s_cnt[2][2][FWD_WARPS];  // [round parity][held, not][warp]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned below = (1u << lane) - 1u;
  int k = 0, e = 0;
  for (int i0 = 0, it = 0; i0 < n; i0 += FWD_THREADS, ++it) {
    const int i = i0 + tid;
    const bool in = i < n, p = in && pred(i);
    const unsigned bp = __ballot_sync(0xffffffffu, p);
    const unsigned bq = __ballot_sync(0xffffffffu, in && !p);
    int (*cnt)[FWD_WARPS] = s_cnt[it & 1];  // double-buffered
    if (lane == 0) {
      cnt[0][warp] = __popc(bp);
      cnt[1][warp] = __popc(bq);
    }
    __syncthreads();
    int op = k, oq = e;
#pragma unroll
    for (int w = 0; w < FWD_WARPS; ++w) {
      op += (w < warp) ? cnt[0][w] : 0;
      oq += (w < warp) ? cnt[1][w] : 0;
      k += cnt[0][w];
      e += cnt[1][w];
    }
    if (p) s_list[op + __popc(bp & below)] = i;
    if (in && !p) s_list[FWD_WINDOW - 1 - (oq + __popc(bq & below))] = i;
  }
  __syncthreads();
  return k;
}

// Heaviest first: s_ord[0, n) = the indices [0, n) ordered by weight
// s_w[i], descending, ties in index order (n <= FWD_WINDOW). A block walks
// items k = 0, 1, ... of its frame as item k·G + g on even rounds and
// k·G + G - 1 - g on odd ones (snake_item), so the heavy tiles start first
// and spread over the blocks. Call with all FWD_THREADS threads after s_w
// is written and visible; ends with a barrier.
__device__ void order_by_weight(int n, const int* s_w, int* s_ord) {
  for (int i = threadIdx.x; i < n; i += FWD_THREADS) {
    const int wi = s_w[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const int wj = s_w[j];
      rank += (wj > wi || (wj == wi && j < i)) ? 1 : 0;
    }
    s_ord[rank] = i;
  }
  __syncthreads();
}

__device__ __forceinline__ int snake_item(int k) {
  return k * (int)gridDim.x + ((k & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// Blocks per frame of a forward kernel: one resident wave over the current
// card (each block then walks its frame's items). The wave is computed once
// per kernel and card: cached[d] for device ordinal d < FWD_MAX_DEVICES
// (zero-initialized by the caller), computed anew on each call past that.
#define FWD_MAX_DEVICES 64
template <class Kernel>
int fwd_grid(Kernel kernel, int B, int* cached) {
  int dev = 0;
  cudaGetDevice(&dev);
  int local = 0;
  int& wave = (dev >= 0 && dev < FWD_MAX_DEVICES) ? cached[dev] : local;
  if (wave <= 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FWD_THREADS, 0);
    wave = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return (wave + B - 1) / B;
}

}  // namespace
