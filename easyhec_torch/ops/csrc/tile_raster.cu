// Per-tile soft-silhouette rasterizer for Hopper (sm_90a): the unfused route.
//
// Replaces the Pallas TPU kernels of easyhec_tpu/ops/tile_raster.py:
//   tile_fwd_kernel  <- _fwd_kernel (K5f, pallas_call :218)
//   tile_bwd_kernel  <- _bwd_kernel (K5b, pallas_call :260)
// Plain PyTorch versions of both live in easyhec_torch/ops/tile_raster.py
// (tile_fwd_plain / tile_bwd_plain), step by step the JAX arithmetic.
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
//   dtri is written everywhere: zeros beyond the count and in rows 13-15.
//
// What bounds them on an H100: at the bench shapes the records are the big
// input (639 MB), but a tile reads only its ceil(count/128) used chunks. The
// forward is bound by FP32 operations (~27 per lane-pixel pair); the
// backward does that work only on the tile's live cotangent pixels.
//
// Design:
// - Forward: one block per (tile, frame, pixel sub-block), grid (T, B, S),
//   one thread per pixel, at most 1024 pixels per sub-block (S =
//   ceil(th*tw / 1024)), so any tile size runs. Each 128-slot chunk's 13
//   field rows are staged in shared memory (the rows are contiguous in slot:
//   the loads coalesce); acc stays in a register per pixel. A slot whose
//   bbox, dilated by the soft band 0.5/s and one pixel of slack, misses the
//   sub-block's pixels has zero coverage there and is skipped (exact). The
//   saturation early-out is a vote over the sub-block before each chunk
//   (min(acc) >= 2): it changes only acc values >= 2, never clip(acc) nor
//   the backward's acc <= 1 mask.
// - Backward: one block per (tile, frame), grid (T, B), 256 threads. The
//   tile's masked cotangent g · 1{acc <= 1} is compacted into a list of live
//   pixels in dynamic shared memory (8 bytes per pixel: 32 KB for a 32x128
//   tile), in pixel order; a tile with none writes zeros. Then per chunk the
//   13 field rows are staged in shared memory and each warp takes a slot:
//   its lanes loop over the live pixels and the 13 sums are warp-reduced in
//   a fixed order. The chunk's [16, 128] results are written coalesced. No
//   float atomics: every dtri entry is written once, by one warp.
// Not carried over from Pallas: the unrolled static chunk loop and the
// 64 MB scoped-VMEM limit (Mosaic workarounds).

#include "pose_raster_common.cuh"

#define TRI_REC 16
#define NFIELD 13
#define BWD_THREADS 256

namespace {

// Slack of the exact cull: coverage is nonzero only where every bbox
// distance exceeds -0.5/s; one more pixel absorbs rounding. sharpness <= 0
// puts coverage outside the triangles too: no cull.
__device__ __forceinline__ float cull_reach(float sharp) {
  return sharp > 0.f ? 0.5f / sharp + 1.f : INFINITY;
}

// --------------------------------------------------------------------------
// Forward: grid (T, B, S), block = min(th*tw, 1024) pixels rounded up to a
// warp multiple.
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(MAX_THREADS) tile_fwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ tri,
    float* __restrict__ out, float* __restrict__ acc_out, int T, int cap,
    int th, int tw, float sharp) {
  const int t = blockIdx.x, b = blockIdx.y, sb = blockIdx.z;
  const int64_t tb = (int64_t)b * T + t;
  const int count = min(counts[tb], cap);

  __shared__ float s_f[NFIELD][CHUNK];
  __shared__ int s_ok[CHUNK];

  const int tid = threadIdx.x;
  const int P = th * tw;
  const int p0 = sb * MAX_THREADS;
  const int pix = p0 + tid;
  const bool active = pix < P;
  const float px = (pix % tw) + 0.5f, py = (pix / tw) + 0.5f;
  // pixel-center rows of this sub-block: [r0 + 0.5, r1 + 0.5]
  const float r0 = (float)(p0 / tw), r1 = (float)((min(P, p0 + MAX_THREADS) - 1) / tw);
  const float reach = cull_reach(sharp);
  const float* rec = tri + tb * TRI_REC * (int64_t)cap;

  float acc = 0.f;
  const int nch = (count + CHUNK - 1) / CHUNK;
  for (int j = 0; j < nch; ++j) {
    if (__syncthreads_and(!active || acc >= 2.f)) break;  // sub-block saturated
    const int k0 = j * CHUNK;
    const int n = min(CHUNK, count - k0);
    for (int i = tid; i < NFIELD * CHUNK; i += blockDim.x) {
      const int f = i / CHUNK, l = i % CHUNK;
      s_f[f][l] = rec[(int64_t)f * cap + k0 + l];
    }
    __syncthreads();
    for (int l = tid; l < CHUNK; l += blockDim.x)
      s_ok[l] = l < n && s_f[11][l] + reach > 0.f && s_f[9][l] - reach < (float)tw &&
                s_f[12][l] + reach > r0 && s_f[10][l] - reach < r1 + 1.f;
    __syncthreads();
    for (int l = 0; l < n; ++l) {
      if (!s_ok[l]) continue;  // uniform over the block
      const float d0 = s_f[0][l] * px + s_f[1][l] * py + s_f[2][l];
      const float d1 = s_f[3][l] * px + s_f[4][l] * py + s_f[5][l];
      const float d2 = s_f[6][l] * px + s_f[7][l] * py + s_f[8][l];
      const float dbb = fminf(fminf(px - s_f[9][l], s_f[11][l] - px),
                              fminf(py - s_f[10][l], s_f[12][l] - py));
      const float dmin = fminf(fminf(fminf(d0, d1), d2), dbb);
      acc += fminf(fmaxf(0.5f + sharp * dmin, 0.f), 1.f);
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
  if (active) {
    acc_out[tb * P + pix] = acc;
    out[tb * P + pix] = fminf(fmaxf(acc, 0.f), 1.f);
  }
}

// --------------------------------------------------------------------------
// Backward: grid (T, B), BWD_THREADS threads, dynamic shared memory of
// 8 bytes per tile pixel (the compacted live cotangent).
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(BWD_THREADS) tile_bwd_kernel(
    const int* __restrict__ counts, const float* __restrict__ tri,
    const float* __restrict__ acc_in, const float* __restrict__ gimg,
    float* __restrict__ dtri, int T, int cap, int th, int tw, float sharp) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int64_t tb = (int64_t)b * T + t;
  const int count = min(counts[tb], cap);

  extern __shared__ unsigned char s_dyn[];
  const int P = th * tw;
  float* s_g = reinterpret_cast<float*>(s_dyn);    // [P] live gp_base values
  int* s_pix = reinterpret_cast<int*>(s_g + P);     // [P] their pixels
  __shared__ float s_f[NFIELD][CHUNK];
  __shared__ float s_out[TRI_REC][CHUNK];
  __shared__ int s_wcnt[BWD_THREADS / 32];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;

  // gp_base = g · 1{acc <= 1}, compacted in pixel order (deterministic).
  int n_live = 0;
  for (int w0 = 0; w0 < P; w0 += blockDim.x) {
    const int p = w0 + tid;
    float g = 0.f;
    if (p < P) g = gimg[tb * P + p] * (acc_in[tb * P + p] <= 1.f ? 1.f : 0.f);
    const unsigned bal = __ballot_sync(0xffffffffu, g != 0.f);
    if (lane == 0) s_wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = n_live, tot = 0;
    for (int w = 0; w < nwarps; ++w) {
      off += (w < warp) ? s_wcnt[w] : 0;
      tot += s_wcnt[w];
    }
    if (g != 0.f) {
      const int pos = off + __popc(bal & ((1u << lane) - 1u));
      s_g[pos] = g;
      s_pix[pos] = p;
    }
    n_live += tot;
    __syncthreads();  // s_wcnt is rewritten by the next window
  }

  const float reach = cull_reach(sharp);
  const float* rec = tri + tb * TRI_REC * (int64_t)cap;
  float* drec = dtri + tb * TRI_REC * (int64_t)cap;
  for (int k0 = 0; k0 < cap; k0 += CHUNK) {
    const int n = (n_live > 0) ? max(0, min(CHUNK, count - k0)) : 0;
    if (n > 0) {
      for (int i = tid; i < NFIELD * CHUNK; i += blockDim.x) {
        const int f = i / CHUNK, l = i % CHUNK;
        s_f[f][l] = rec[(int64_t)f * cap + k0 + l];
      }
    }
    __syncthreads();
    for (int l = warp; l < CHUNK; l += nwarps) {
      // sums: [3e+0] Σgp·px, [3e+1] Σgp·py, [3e+2] Σgp per edge arm e;
      //       [9] lox, [10] loy, [11] hix, [12] hiy for the bbox arm
      float s13[NFIELD];
#pragma unroll
      for (int k = 0; k < NFIELD; ++k) s13[k] = 0.f;
      const bool live = l < n && s_f[11][l] + reach > 0.f &&
                        s_f[9][l] - reach < (float)tw && s_f[12][l] + reach > 0.f &&
                        s_f[10][l] - reach < (float)th;  // warp-uniform
      if (live) {
        const float a0 = s_f[0][l], b0 = s_f[1][l], c0 = s_f[2][l];
        const float a1 = s_f[3][l], b1 = s_f[4][l], c1 = s_f[5][l];
        const float a2 = s_f[6][l], b2 = s_f[7][l], c2 = s_f[8][l];
        const float lox = s_f[9][l], loy = s_f[10][l];
        const float hix = s_f[11][l], hiy = s_f[12][l];
        for (int k = lane; k < n_live; k += 32) {
          const int p = s_pix[k];
          const float px = (p % tw) + 0.5f, py = (p / tw) + 0.5f;
          const float d0 = a0 * px + b0 * py + c0;
          const float d1 = a1 * px + b1 * py + c1;
          const float d2 = a2 * px + b2 * py + c2;
          const float dbb = fminf(fminf(px - lox, hix - px), fminf(py - loy, hiy - py));
          const float dmin = fminf(fminf(fminf(d0, d1), d2), dbb);
          const float cov = fminf(fmaxf(0.5f + sharp * dmin, 0.f), 1.f);
          if (!(cov > 0.f && cov < 1.f)) continue;  // outside the slot's band
          const float gp = s_g[k] * sharp;
          int arm = 3;  // first matching arm of the 4-way min
          if (d0 <= dmin) arm = 0;
          else if (d1 <= dmin) arm = 1;
          else if (d2 <= dmin) arm = 2;
          if (arm < 3) {
            s13[3 * arm] += gp * px;
            s13[3 * arm + 1] += gp * py;
            s13[3 * arm + 2] += gp;
          } else if ((px - lox) <= dbb) {
            s13[9] -= gp;
          } else if ((hix - px) <= dbb) {
            s13[11] += gp;
          } else if ((py - loy) <= dbb) {
            s13[10] -= gp;
          } else {
            s13[12] += gp;
          }
        }
#pragma unroll
        for (int k = 0; k < NFIELD; ++k) s13[k] = warp_sum(s13[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NFIELD; ++k) s_out[k][l] = s13[k];
#pragma unroll
        for (int k = NFIELD; k < TRI_REC; ++k) s_out[k][l] = 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < TRI_REC * CHUNK; i += blockDim.x) {
      const int f = i / CHUNK, l = i % CHUNK;
      drec[(int64_t)f * cap + k0 + l] = s_out[f][l];
    }
    __syncthreads();  // s_f and s_out are rewritten by the next chunk
  }
}

int bwd_smem_bytes(int P) { return P * (int)(sizeof(float) + sizeof(int)); }

}  // namespace

// K5f: counts [B, T], tri [B, T, 16, cap] -> out = clip(acc), acc [B, T, th, tw].
extern "C" int easyhec_tile_fwd(const int* counts, const float* tri, float* out,
                                float* acc, int B, int T, int cap, int th,
                                int tw, float sharp, void* stream) {
  const int P = th * tw;
  if (P <= 0 || B <= 0 || B > 65535 || T <= 0 || cap <= 0 || cap % CHUNK != 0 ||
      n_sub(P) > 65535)
    return (int)cudaErrorInvalidValue;
  tile_fwd_kernel<<<dim3(T, B, n_sub(P)), sub_threads(P), 0,
                    (cudaStream_t)stream>>>(counts, tri, out, acc, T, cap, th,
                                            tw, sharp);
  return (int)cudaGetLastError();
}

// K5b: + acc, g [B, T, th, tw] -> dtri [B, T, 16, cap].
extern "C" int easyhec_tile_bwd(const int* counts, const float* tri,
                                const float* acc, const float* g, float* dtri,
                                int B, int T, int cap, int th, int tw,
                                float sharp, void* stream) {
  const int P = th * tw;
  if (P <= 0 || B <= 0 || B > 65535 || T <= 0 || cap <= 0 || cap % CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = bwd_smem_bytes(P);
  // Past 32 KB, dynamic and static shared memory (15 KB) together would
  // exceed the default 48 KB per block: raise the limit (up to 227 KB).
  static int smem_set = 32 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  tile_bwd_kernel<<<dim3(T, B), BWD_THREADS, smem, (cudaStream_t)stream>>>(
      counts, tri, acc, g, dtri, T, cap, th, tw, sharp);
  return (int)cudaGetLastError();
}
