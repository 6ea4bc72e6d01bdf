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
// a clamp. The backward's bound is bytes (~11 MB, 3.3 us at the bench start
// pose): its pairs are only those on live cotangent pixels (the band under
// band_only, ~2.2 M pairs over ~1,500 chunks), plus a setup and a chain per
// slot. What holds it on the card is latency: a block's chain of loads
// (map, cotangent tile, records) and a short sweep.
//
// Design:
// - Blocks run in no order, so ONE BLOCK OWNS ONE TILE (or one pixel
//   sub-block of it): the forward grid is (nc, B, S) and only the blocks of
//   a tile's first chunk proceed; each walks the tile's consecutive chunks
//   itself, keeping acc in a register per pixel (one thread per pixel, at
//   most 1024 pixels per sub-block, S = ceil(th*tw / 1024)). No atomics, no
//   cross-block accumulation, and the acc tile is written exactly once. The
//   loss is written per sub-block, loss_tiles [B, T, S]; the wrapper sums
//   over S in a fixed order.
// - Per chunk, threads build the per-triangle setup (projection, validity,
//   normalized edges, poisoned bbox) into shared memory once; every pixel
//   thread then sweeps the chunk's live lanes from shared memory, so the
//   inner loop is pure FP32 arithmetic on broadcast operands.
// - The saturation early-out is a block vote (__syncthreads_and(acc >= 2))
//   over the sub-block, which changes only acc values >= 2, never clip(acc).
// - The per-tile loss is a fixed-order block reduction (deterministic).
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

namespace {

// --------------------------------------------------------------------------
// Forward: grid (nc, B, S), block = min(th*tw, 1024) pixels rounded up to a
// warp multiple.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_THREADS) loss_fwd_compact_kernel(
    const int* __restrict__ nlive, const int* __restrict__ ctmap,
    const int* __restrict__ ncu, const float* __restrict__ cam,
    const float* __restrict__ rec, const float* __restrict__ ref,
    float* __restrict__ acc_out, float* __restrict__ loss_tiles, int nc,
    int T, int th, int tw, int n_tx, int H, int W, float sharp, float near,
    float far) {
  const int c = blockIdx.x, b = blockIdx.y, sb = blockIdx.z;
  const int* ct = ctmap + (int64_t)b * nc;
  const int t = ct[c];
  if (c > 0 && ct[c - 1] == t) return;  // not the first chunk of its tile

  __shared__ float s_e[9][CHUNK];    // a0 b0 c0 a1 b1 c1 a2 b2 c2
  __shared__ float s_box[4][CHUNK];  // lox loy hix hiy
  __shared__ float s_red[MAX_THREADS / 32];

  const int tid = threadIdx.x;
  const int P = th * tw;
  const int pix = sb * MAX_THREADS + tid;  // pixel of the tile
  const bool active = pix < P;
  const int ix = pix % tw, iy = pix / tw;
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
    acc_out[tb * P + pix] = acc;
    const float e = fminf(fmaxf(acc, 0.f), 1.f) - ref[tb * P + pix];
    const bool in_img = (y0 + iy < H) && (x0 + ix < W);
    sq = in_img ? e * e : 0.f;
  }
  const float tot = block_sum(sq, s_red);
  if (tid == 0 && ncu[b] > 0) loss_tiles[tb * gridDim.z + sb] = tot;
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
  const int P = th * tw;
  if (P <= 0 || B <= 0 || B > 65535 || nc <= 0 || n_sub(P) > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = sub_threads(P);
  loss_fwd_compact_kernel<<<dim3(nc, B, n_sub(P)), threads, 0,
                            (cudaStream_t)stream>>>(
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
