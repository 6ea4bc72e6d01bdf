// Counting-sort tile binning for Hopper (sm_90a): the binner of every bin
// state on the card (render/binning.py::bin_count on CUDA tensors, through
// ops/binning.py::bin_count_cuda).
//
// Replaces no Pallas kernel: the JAX package bins with XLA
// (easyhec_tpu/render/binning.py::bin_count, ranks from per-chunk histograms
// and a triangular matmul). The plain version, render/binning.py
// ::_bin_count_flat, enumerates a static window of (triangle, tile) entries
// per triangle, gives the unused ones a sentinel key and sorts them all; at
// the explorer's scoring shape (960x540, 16x64 tiles, rect 21x7, big_k
// 10752) that is 1.62 M entries a frame, of which at most ~25 k are real.
// These kernels enumerate only the real entries and rank them without a
// sort. idx, counts, q and overflow equal the plain version's bit for bit.
//
// Contract (the plain version's). Per frame: a triangle is used if valid and
// its bbox reaches the image; its tile rect is [ty0, ty1] x [tx0, tx1]
// (floor(coordinate / tile size), clamped to the grid).
//   - big_k = 0: one group; the entries are the rect's tiles inside the
//     ry x rx window, q column iy*rx + ix.
//   - big_k > 0: a "small" triangle (rect <= by = min(2, ry) rows x 1
//     column) enters group 0 with its rows (q column iy); a larger one
//     ("need_big") enters group 1 with the window's tiles (q column by +
//     iy*rx + ix) if its rank among the frame's need_big triangles is below
//     big_k, else nothing.
//   - suby (bbox centre y) given: an entry's class is 1 where the centre lies
//     in the lower half of the entry's tile row, else 0; without it, one
//     class.
//   - Within a tile, an entry's slot is the tile's class-0 total if its class
//     is 1, plus its rank among the tile's entries of its class, ordered by
//     group, then by triangle. Slots at or past cap are dropped: idx[tile,
//     slot] = triangle and q[triangle, column] = tile*cap + slot only below
//     cap; unused idx slots hold F and unused q entries K*cap; counts =
//     min(total, cap).
//   - overflow: a rect past the window, more need_big triangles than big_k,
//     or a tile total past cap.
// Floating point as the plain version on the CPU: true division by the tile
// size (the same as a product by its reciprocal for a power of two, which
// every configuration of the repository has), the class test op by op.
//
// What bounds it on an H100: writing its outputs. idx [B, K*cap] and q
// [B, F, R] are written whole: 105 MB a bin state at the explorer's scoring
// shape (B = 5), 31 us at 3.35 TB/s. The real entries and the per-chunk
// histograms are small beside them.
//
// Design: four kernels; no sort, no global atomics, no int64 temporaries.
// Each idx slot is written once (F past the tile's count, else its entry);
// a chunk's q rows are written by its own block only, the fill before the
// entries across a barrier. So two launches are bit-identical.
//   bin_prep_kernel  (chunk of 256 triangles, frame): the chunk's count of
//                    need_big triangles and whether a rect of it passes the
//                    window.
//   bin_hist_kernel  (chunk, frame): each triangle's need_big rank (the
//                    earlier chunks' counts plus a block scan) decides its
//                    entries; each warp walks its 32 triangles' real entries
//                    32 at a time, in (triangle, entry) order (walk_warp),
//                    counting them in a shared histogram keyed (tile, class,
//                    group) that the block writes out as its row of hist.
//   bin_scan_kernel  (tile, frame): per tile, an exclusive scan over (class,
//                    group, chunk) turns hist into each chunk's first slot
//                    per key; the total gives counts.
//   bin_place_kernel (chunk, frame): fills the chunk's q rows with K*cap and
//                    its share of the frame's idx slots at or past each
//                    tile's count with F; then the warps, in warp order, walk
//                    their entries again: a warp match ranks equal keys among
//                    the 32 entries at hand (lower lanes hold lower
//                    triangles), a shared cursor per key carries the count
//                    across batches and warps, and slot = cursor + rank is
//                    written to idx and q where it is below cap. Block 0 of
//                    each frame reduces its overflow flag.
// A histogram of more than MAX_KEYS keys is done in passes over key ranges.
// Every launch reads only device memory and allocates nothing, so the four
// can be captured in a CUDA graph or a conditional node's body.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;  // triangles per chunk, one per thread
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 128;
// Shared histogram keys per pass: with the kernels' static shared memory
// (big_rank's 64 bytes, s_nbig) within the 48 KB a launch gets without an
// opt-in.
constexpr int MAX_KEYS = 12032;
constexpr unsigned FULL = 0xffffffffu;

struct Inputs {
  const float* lox;
  const float* loy;
  const float* hix;
  const float* hiy;
  const unsigned char* valid;
  const float* suby;  // null: one class
};

struct Dims {
  int F, H, W, th, tw, n_ty, n_tx, K, cap, ry, rx, by, big_k, R, ncls, ng, nch, kg;
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// floor(v / t) clamped to [0, n - 1], as the plain version's
// clamp(floor(v / t).long(), 0, n - 1) on the card (saturating conversion).
__device__ __forceinline__ int tile_of(float v, int t, int n) {
  const float c = floorf(__fdiv_rn(v, (float)t));
  return (int)fminf(fmaxf(c, 0.f), (float)(n - 1));
}

// One triangle's tile rect: first tile row and column, spans, used, need_big.
struct Tri {
  int ty0, tx0, sy, sx;
  bool use, need_big;
};

__device__ __forceinline__ Tri tri_at(const Inputs& in, const Dims& d, int b, int f) {
  Tri t{0, 0, 0, 0, false, false};
  if (f >= d.F) return t;
  const size_t i = (size_t)b * d.F + f;
  const float x0 = in.lox[i], y0 = in.loy[i], x1 = in.hix[i], y1 = in.hiy[i];
  t.use = in.valid[i] && x1 > 0.f && x0 < (float)d.W && y1 > 0.f && y0 < (float)d.H;
  t.ty0 = tile_of(y0, d.th, d.n_ty);
  t.tx0 = tile_of(x0, d.tw, d.n_tx);
  t.sy = tile_of(y1, d.th, d.n_ty) - t.ty0 + 1;
  t.sx = tile_of(x1, d.tw, d.n_tx) - t.tx0 + 1;
  t.need_big = d.ng == 2 && t.use && (t.sy > d.by || t.sx > 1);
  return t;
}

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// A triangle's real entries: ny rows x nx columns of tiles from (ty0, tx0)
// in group g.
struct Run {
  int ty0, tx0, ny, nx, g;
  float suby;
};

__device__ __forceinline__ Run run_of(const Tri& t, const Dims& d, int big_rank,
                                      const Inputs& in, int b, int f) {
  Run r{t.ty0, t.tx0, 0, 0, 0, 0.f};
  if (!t.use) return r;
  if (d.ng == 1) {
    r.ny = clampi(t.sy, d.ry);
    r.nx = clampi(t.sx, d.rx);
  } else if (!t.need_big) {  // its rows at column tx0 (a span of 1 or less)
    r.ny = clampi(t.sy, d.by);
    r.nx = 1;
  } else if (big_rank < d.big_k) {
    r.ny = clampi(t.sy, d.ry);
    r.nx = clampi(t.sx, d.rx);
    r.g = 1;
  }
  if (in.suby) r.suby = in.suby[(size_t)b * d.F + f];
  return r;
}

// Rank of this thread's triangle among the frame's need_big triangles:
// the earlier chunks' counts (nbig_b) plus the block's lower threads'.
// Called by every thread of the block.
__device__ int big_rank(bool need_big, const int* nbig_b, int chunk) {
  __shared__ int s_before[WARPS], s_n[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int part = 0;
  for (int c = threadIdx.x; c < chunk; c += THREADS) part += nbig_b[c];
  part = __reduce_add_sync(FULL, part);
  const unsigned bal = __ballot_sync(FULL, need_big);
  if (lane == 0) {
    s_before[warp] = part;
    s_n[warp] = __popc(bal);
  }
  __syncthreads();
  int r = __popc(bal & ((1u << lane) - 1u));
  for (int w = 0; w < WARPS; ++w) r += s_before[w] + (w < warp ? s_n[w] : 0);
  return r;
}

// One entry of a warp's walk. key = (tile*ncls + cls)*ng + g, negative
// (and unique to the lane) where the lane holds none.
struct Entry {
  bool ok;
  int owner;  // lane of the entry's triangle
  int key, tile, qcol;
};

// The warp's real entries in (lane, entry) order, 32 at a time: fn(Entry)
// is called by all 32 lanes for each batch (collectives may be used in it).
template <class Fn>
__device__ __forceinline__ void walk_warp(const Run& r, const Dims& d, Fn&& fn) {
  const int lane = threadIdx.x & 31;
  const int n = r.ny * r.nx;
  int incl = n;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, s);
    if (lane >= s) incl += v;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  const int excl = incl - n;
  for (int e0 = 0; e0 < total; e0 += 32) {
    const int e = e0 + lane;
    int o = 0;  // lanes whose entries end at or before e
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      if (__shfl_sync(FULL, incl, o + s - 1) <= e) o += s;
    const int oex = __shfl_sync(FULL, excl, o);
    const int oty = __shfl_sync(FULL, r.ty0, o);
    const int otx = __shfl_sync(FULL, r.tx0, o);
    const int onx = __shfl_sync(FULL, r.nx, o);
    const int og = __shfl_sync(FULL, r.g, o);
    const float osub = __shfl_sync(FULL, r.suby, o);
    Entry en{e < total, o, -1 - lane, 0, 0};
    if (en.ok) {
      const int local = e - oex, iy = local / onx, ix = local - iy * onx;
      const int ty = oty + iy;
      en.tile = ty * d.n_tx + otx + ix;
      int cls = 0;
      if (d.ncls == 2)
        cls = __fmul_rn(__fsub_rn(osub, __fmul_rn((float)ty, (float)d.th)), 2.f) >=
              (float)d.th;
      en.key = (en.tile * d.ncls + cls) * d.ng + og;
      en.qcol = og ? d.by + iy * d.rx + ix : (d.ng == 2 ? iy : iy * d.rx + ix);
    }
    fn(en);
  }
}

// --------------------------------------------------------------------------
// grid (nch, B), THREADS threads
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS) bin_prep_kernel(Inputs in, Dims d, int* nbig,
                                                           int* rov) {
  const int b = blockIdx.y, chunk = blockIdx.x;
  const Tri t = tri_at(in, d, b, chunk * THREADS + threadIdx.x);
  const int n = __syncthreads_count(t.need_big);
  const int over = __syncthreads_or(t.use && (t.sy > d.ry || t.sx > d.rx));
  if (threadIdx.x == 0) {
    nbig[(size_t)b * d.nch + chunk] = n;
    rov[(size_t)b * d.nch + chunk] = over;
  }
}

__global__ void __launch_bounds__(THREADS) bin_hist_kernel(Inputs in, Dims d,
                                                           const int* __restrict__ nbig,
                                                           int* __restrict__ hist) {
  extern __shared__ int sh[];
  const int b = blockIdx.y, chunk = blockIdx.x, f = chunk * THREADS + threadIdx.x;
  const Tri t = tri_at(in, d, b, f);
  const int rank = d.ng == 2 ? big_rank(t.need_big, nbig + (size_t)b * d.nch, chunk) : 0;
  const Run r = run_of(t, d, rank, in, b, f);
  int* out = hist + ((size_t)b * d.nch + chunk) * d.kg;
  for (int k0 = 0; k0 < d.kg; k0 += MAX_KEYS) {
    const int nk = min(MAX_KEYS, d.kg - k0);
    for (int i = threadIdx.x; i < nk; i += THREADS) sh[i] = 0;
    __syncthreads();
    walk_warp(r, d, [&](const Entry& en) {
      if (en.ok && en.key >= k0 && en.key - k0 < nk) atomicAdd(&sh[en.key - k0], 1);
    });
    __syncthreads();
    for (int i = threadIdx.x; i < nk; i += THREADS) out[k0 + i] = sh[i];
    __syncthreads();
  }
}

// grid (cdiv(K, SCAN_THREADS), B): one thread per tile. hist's row of each
// chunk holds the tile's ncls*ng keys side by side; the scan runs over
// (class, group, chunk) in that order, in place.
__global__ void __launch_bounds__(SCAN_THREADS) bin_scan_kernel(Dims d, int* __restrict__ hist,
                                                                int* __restrict__ tot,
                                                                int* __restrict__ counts) {
  const int tile = blockIdx.x * SCAN_THREADS + threadIdx.x, b = blockIdx.y;
  if (tile >= d.K) return;
  const int G = d.ncls * d.ng;
  int* h = hist + (size_t)b * d.nch * d.kg + (size_t)tile * G;
  int off[4] = {0, 0, 0, 0};
  for (int c = 0; c < d.nch; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < G) off[j] += h[(size_t)c * d.kg + j];
    }
  }
  int total = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < G) {
      const int s = off[j];
      off[j] = total;
      total += s;
    }
  }
  for (int c = 0; c < d.nch; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < G) {
        int* p = h + (size_t)c * d.kg + j;
        const int v = *p;
        *p = off[j];
        off[j] += v;
      }
    }
  }
  tot[(size_t)b * d.K + tile] = total;
  counts[(size_t)b * d.K + tile] = min(total, d.cap);
}

__global__ void __launch_bounds__(THREADS) bin_place_kernel(
    Inputs in, Dims d, const int* __restrict__ nbig, const int* __restrict__ rov,
    const int* __restrict__ first, const int* __restrict__ tot, int* __restrict__ idx,
    int* __restrict__ q, unsigned char* __restrict__ overflow) {
  extern __shared__ int sh[];
  __shared__ int s_nbig;
  const int b = blockIdx.y, chunk = blockIdx.x, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  const int f0 = chunk * THREADS, f = f0 + threadIdx.x;
  const int* tot_b = tot + (size_t)b * d.K;
  int* idx_b = idx + (size_t)b * d.K * d.cap;

  // q rows of the chunk: unused (K*cap) everywhere; the entries overwrite
  // theirs after the barrier in big_rank or the pass's first barrier.
  int* qc = q + ((size_t)b * d.F + f0) * d.R;
  const int nq = (min(d.F, f0 + THREADS) - f0) * d.R;
  for (int i = threadIdx.x; i < nq; i += THREADS) qc[i] = d.K * d.cap;
  // idx: this chunk's share of the frame's tiles, the slots past the count.
  const int per = cdiv(d.K, d.nch);
  for (int tile = chunk * per; tile < min(d.K, (chunk + 1) * per); ++tile) {
    int* row = idx_b + (size_t)tile * d.cap;
    for (int s = min(tot_b[tile], d.cap) + threadIdx.x; s < d.cap; s += THREADS) row[s] = d.F;
  }
  if (chunk == 0) {  // the frame's overflow flag
    int over = 0, n = 0;
    for (int tile = threadIdx.x; tile < d.K; tile += THREADS) over |= tot_b[tile] > d.cap;
    for (int c = threadIdx.x; c < d.nch; c += THREADS) {
      over |= rov[(size_t)b * d.nch + c];
      n += nbig[(size_t)b * d.nch + c];
    }
    if (threadIdx.x == 0) s_nbig = 0;
    __syncthreads();
    n = __reduce_add_sync(FULL, n);
    if (lane == 0 && n) atomicAdd(&s_nbig, n);
    over = __syncthreads_or(over);
    if (threadIdx.x == 0) overflow[b] = over || (d.ng == 2 && s_nbig > d.big_k);
  }

  const Tri t = tri_at(in, d, b, f);
  const int rank = d.ng == 2 ? big_rank(t.need_big, nbig + (size_t)b * d.nch, chunk) : 0;
  const Run r = run_of(t, d, rank, in, b, f);
  const int* first_c = first + ((size_t)b * d.nch + chunk) * d.kg;
  const unsigned lower = (1u << lane) - 1u;
  for (int k0 = 0; k0 < d.kg; k0 += MAX_KEYS) {
    const int nk = min(MAX_KEYS, d.kg - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < nk; i += THREADS) sh[i] = first_c[k0 + i];
    __syncthreads();
    for (int w = 0; w < WARPS; ++w) {
      if (warp == w)
        walk_warp(r, d, [&](const Entry& en) {
          const bool mine = en.ok && en.key >= k0 && en.key - k0 < nk;
          const unsigned peers = __match_any_sync(FULL, mine ? en.key : -1 - lane);
          const int before = __popc(peers & lower);
          const int slot = mine ? sh[en.key - k0] + before : 0;
          __syncwarp();
          if (mine) {
            if (before == 0) sh[en.key - k0] += __popc(peers);
            if (slot < d.cap) {
              const int fo = f0 + w * 32 + en.owner;
              idx_b[(size_t)en.tile * d.cap + slot] = fo;
              q[((size_t)b * d.F + fo) * d.R + en.qcol] = en.tile * d.cap + slot;
            }
          }
          __syncwarp();
        });
      __syncthreads();
    }
  }
}

bool dims_of(int F, int H, int W, int th, int tw, int cap, int ry, int rx, int big_k,
             int with_suby, Dims& d) {
  if (F <= 0 || H <= 0 || W <= 0 || th <= 0 || tw <= 0 || cap <= 0 || ry <= 0 || rx <= 0 ||
      big_k < 0)
    return false;
  d.F = F;
  d.H = H;
  d.W = W;
  d.th = th;
  d.tw = tw;
  d.n_ty = cdiv(H, th);
  d.n_tx = cdiv(W, tw);
  d.cap = cap;
  d.ry = ry;
  d.rx = rx;
  d.by = std::min(2, ry);
  d.big_k = std::min(big_k, F);
  d.ng = big_k > 0 ? 2 : 1;
  d.ncls = with_suby ? 2 : 1;
  const long long K = (long long)d.n_ty * d.n_tx;
  const long long R = (long long)ry * rx + (big_k > 0 ? d.by : 0);
  if (K * cap >= 0x7fffffffLL || R * THREADS >= 0x7fffffffLL ||
      K * d.ncls * d.ng >= 0x7fffffffLL)
    return false;
  d.K = (int)K;
  d.R = (int)R;
  d.nch = cdiv(F, THREADS);
  d.kg = d.K * d.ncls * d.ng;
  return true;
}

}  // namespace

extern "C" {

// int32 scratch entries bin_count needs for these dims (nbig, rov, tot,
// hist), or -1 where it takes none of them.
long long easyhec_bin_scratch_ints(int B, int F, int H, int W, int th, int tw, int cap,
                                   int ry, int rx, int big_k, int with_suby) {
  Dims d;
  if (B <= 0 || B > 65535 || !dims_of(F, H, W, th, tw, cap, ry, rx, big_k, with_suby, d))
    return -1;
  return (long long)B * (2LL * d.nch + d.K + (long long)d.nch * d.kg);
}

// lox, loy, hix, hiy [B, F] f32, valid [B, F] bool, suby [B, F] f32 or null
// -> idx [B, K, cap], counts [B, K], q [B, F, R] int32, overflow [B] bool.
// scratch: easyhec_bin_scratch_ints(...) int32 entries. Returns the
// cudaError_t of the launches, 0 on success.
int easyhec_bin_count(const float* lox, const float* loy, const float* hix, const float* hiy,
                      const unsigned char* valid, const float* suby, int* idx, int* counts,
                      int* q, unsigned char* overflow, int* scratch, int B, int F, int H, int W,
                      int th, int tw, int cap, int ry, int rx, int big_k, void* stream) {
  Dims d;
  if (B <= 0 || B > 65535 ||
      !dims_of(F, H, W, th, tw, cap, ry, rx, big_k, suby != nullptr, d))
    return (int)cudaErrorInvalidValue;
  const Inputs in{lox, loy, hix, hiy, valid, suby};
  const auto s = (cudaStream_t)stream;
  int* nbig = scratch;
  int* rov = nbig + (size_t)B * d.nch;
  int* tot = rov + (size_t)B * d.nch;
  int* hist = tot + (size_t)B * d.K;
  const dim3 grid(d.nch, B);
  const size_t smem = (size_t)std::min(d.kg, MAX_KEYS) * sizeof(int);
  bin_prep_kernel<<<grid, THREADS, 0, s>>>(in, d, nbig, rov);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bin_hist_kernel<<<grid, THREADS, smem, s>>>(in, d, nbig, hist);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bin_scan_kernel<<<dim3(cdiv(d.K, SCAN_THREADS), B), SCAN_THREADS, 0, s>>>(d, hist, tot,
                                                                            counts);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bin_place_kernel<<<grid, THREADS, smem, s>>>(in, d, nbig, rov, hist, tot, idx, q, overflow);
  return (int)cudaGetLastError();
}

}  // extern "C"
