// The calibration step's pose math around the fused loss kernels, for Hopper
// (sm_90a): models/calib.py::_Scan's kernel route on CUDA tensors, through
// ops/step.py.
//
// Replaces no Pallas kernel: the JAX package leaves this work to XLA, which
// fuses the scan body's se(3) exponential, its chain to Tc[:3,:4], the Adam
// update and the drift probe into a few fusions. Eagerly in PyTorch (and in a
// CUDA graph of PyTorch's kernels) the same work was ~340 small kernels a
// step, each at the card's ~1.5 us floor. It moves a few KB a step (the pose,
// the optimizer's leaves, the probes, the per-frame loss partials and K2b's
// pose partials), so what bounds it is launch latency and one block's
// serial work, not bytes: three kernels a step.
//
//   step_head_kernel   (1 block): Tc = exp(dof) (geometry/se3.py's closed
//                      forms, and its Taylor branch below theta 0.2), the
//                      kernel camera rows cam [B, 16] (fused.cam_rows), the
//                      analytic Jacobian d Tc[:3,:4] / d dof [12, 6] and, in
//                      the rebin, the probe pixels under Tc.
//   step_grad_kernel   (a few blocks a frame): a slice of the frame's loss
//                      (K2f's per-tile partials, and on the compact route the
//                      empty tiles' sum of ref^2), times its weight, and of
//                      the sum of K2b's pose partials, into a scratch row; the
//                      last block to finish (an integer ticket) sums the rows
//                      and writes [loss, g = J^T dL/dTc] (7 floats). Every sum
//                      has a fixed order; no float atomics.
//   step_update_kernel (1 block): make_optimizer's update of a bare tensor in
//                      optax's order (global-norm and value clips, Adam with
//                      its bias corrections and weight decay, or SGD's trace,
//                      then -lr), the loss and pose traces at the step index,
//                      the new pose, and the next step's rebin flag: the
//                      probes' largest pixel drift under exp(new pose) past the
//                      budget, or the end of a fixed cadence's window.
//
// The exponential and the probe projection round every product, sum and
// quotient on its own (__fmul_rn, __fadd_rn, __fdiv_rn; no contraction into
// FMAs), so the head (in the rebin) and the update give the same probe pixels
// for the same pose bit for bit: the drift reads exactly 0 at a state's build
// pose. sinf, cosf and sqrtf are the precise ones (no --use_fast_math).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 12;  // Tc[:3,:4], row-major
constexpr int DOF = 6;    // (v, w)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// torch.max's NaN rule: a NaN on either side wins
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// se3._V_coeffs' A, B, C of theta^2 and their derivatives in theta^2.
struct Coeffs {
  float A, B, C, dA, dB, dC;
};

__device__ Coeffs v_coeffs(float t2) {
  Coeffs k;
  if (t2 < 0.04f) {  // theta < 0.2: the three-term series and their derivatives
    const float t4 = mul(t2, t2);
    k.A = add(sub(1.f, dvd(t2, 6.f)), dvd(t4, 120.f));
    k.B = add(sub(0.5f, dvd(t2, 24.f)), dvd(t4, 720.f));
    k.C = add(sub(1.f / 6.f, dvd(t2, 120.f)), dvd(t4, 5040.f));
    k.dA = -1.f / 6.f + t2 * (2.f / 120.f);
    k.dB = -1.f / 24.f + t2 * (2.f / 720.f);
    k.dC = -1.f / 120.f + t2 * (2.f / 5040.f);
  } else {
    const float th = __fsqrt_rn(t2);
    const float s = sinf(th), c = cosf(th);
    k.A = dvd(s, th);
    k.B = dvd(sub(1.f, c), t2);
    k.C = dvd(sub(th, s), mul(t2, th));
    k.dA = (c - k.A) / (2.f * t2);
    k.dB = (k.A - 2.f * k.B) / (2.f * t2);
    k.dC = (k.B - 3.f * k.C) / (2.f * t2);
  }
  return k;
}

// T [12] = exp(xi)[:3, :4] as se3.exp computes it, op for op.
__device__ void se3_exp(const float xi[DOF], float T[ROWS], Coeffs* out = nullptr) {
  const float v0 = xi[0], v1 = xi[1], v2 = xi[2], w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float w[3] = {w0, w1, w2}, v[3] = {v0, v1, v2};
  const float t2 = add(add(mul(w0, w0), mul(w1, w1)), mul(w2, w2));
  const Coeffs k = v_coeffs(t2);
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float w2ij = sub(mul(w[i], w[j]), i == j ? t2 : 0.f);
      T[i * 4 + j] = add(add(i == j ? 1.f : 0.f, mul(k.A, W[i][j])), mul(k.B, w2ij));
    }
  const float wxv[3] = {sub(mul(w1, v2), mul(w2, v1)), sub(mul(w2, v0), mul(w0, v2)),
                        sub(mul(w0, v1), mul(w1, v0))};
  const float wdv = add(add(mul(w0, v0), mul(w1, v1)), mul(w2, v2));
  for (int i = 0; i < 3; ++i)
    T[i * 4 + 3] = add(add(v[i], mul(k.B, wxv[i])),
                       mul(k.C, sub(mul(w[i], wdv), mul(t2, v[i]))));
  if (out) *out = k;
}

// J [12, 6] = d exp(xi)[:3, :4] / d xi, row r = 4 i + j. R = I + A W + B W^2
// and t = v + B (w x v) + C (w (w.v) - theta^2 v), with A, B, C functions of
// theta^2 (d theta^2 / d w_k = 2 w_k) and d W^2 / d w_k = e_k w^T + w e_k^T -
// 2 w_k I.
__device__ void se3_jacobian(const float xi[DOF], float J[ROWS * DOF]) {
  const float v[3] = {xi[0], xi[1], xi[2]}, w[3] = {xi[3], xi[4], xi[5]};
  const float t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const Coeffs k = v_coeffs(t2);
  const float W[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]}, {-w[1], w[0], 0.f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) W2[i][j] = w[i] * w[j] - (i == j ? t2 : 0.f);
  const float wxv[3] = {w[1] * v[2] - w[2] * v[1], w[2] * v[0] - w[0] * v[2],
                        w[0] * v[1] - w[1] * v[0]};
  const float wdv = w[0] * v[0] + w[1] * v[1] + w[2] * v[2];
  for (int i = 0; i < 3; ++i) {
    for (int m = 0; m < 3; ++m) {  // d/dv: R does not depend on v; dt/dv = V
      for (int j = 0; j < 3; ++j) J[(i * 4 + j) * DOF + m] = 0.f;
      J[(i * 4 + 3) * DOF + m] = (i == m ? 1.f : 0.f) + k.B * W[i][m] + k.C * W2[i][m];
    }
    for (int kk = 0; kk < 3; ++kk) {  // d/dw_kk
      const float e[3] = {kk == 0 ? 1.f : 0.f, kk == 1 ? 1.f : 0.f, kk == 2 ? 1.f : 0.f};
      const float Ek[3][3] = {{0.f, -e[2], e[1]}, {e[2], 0.f, -e[0]}, {-e[1], e[0], 0.f}};
      const float s2 = 2.f * w[kk];
      for (int j = 0; j < 3; ++j) {
        const float dW2 = e[i] * w[j] + w[i] * e[j] - (i == j ? s2 : 0.f);
        J[(i * 4 + j) * DOF + 3 + kk] =
            k.A * Ek[i][j] + k.B * dW2 + s2 * (k.dA * W[i][j] + k.dB * W2[i][j]);
      }
      const float ekxv = Ek[i][0] * v[0] + Ek[i][1] * v[1] + Ek[i][2] * v[2];
      J[(i * 4 + 3) * DOF + 3 + kk] =
          k.B * ekxv + k.C * (e[i] * wdv + w[i] * v[kk] - s2 * v[i]) +
          s2 * (k.dB * wxv[i] + k.dC * (w[i] * wdv - t2 * v[i]));
    }
  }
}

// calib.make_drift_probe_fn: the pixel of base-frame point p under T and K
// (depth clamped at 0.05; a NaN depth stays NaN, as torch.clamp keeps it).
__device__ __forceinline__ void project(const float T[ROWS], const float* p, const float* K,
                                        float* uv) {
  float c[3];
  for (int i = 0; i < 3; ++i)
    c[i] = add(add(add(mul(p[0], T[i * 4]), mul(p[1], T[i * 4 + 1])), mul(p[2], T[i * 4 + 2])),
               T[i * 4 + 3]);
  const float z = c[2] < 0.05f ? 0.05f : c[2];
  uv[0] = add(dvd(mul(K[0], c[0]), z), K[2]);
  uv[1] = add(dvd(mul(K[4], c[1]), z), K[5]);
}

struct Head {
  const float* dof;     // [6]
  const float* K;       // [3, 3]
  float* Tc;            // [4, 4]
  float* cam;           // [B, 16]
  float* jac;           // [12, 6]
  const float* probes;  // [P, 3] base-frame probe points, or null
  float* pix;           // [P, 2]
  int B, P;
};

__global__ void __launch_bounds__(THREADS) step_head_kernel(Head h) {
  __shared__ float T[ROWS];
  const int tid = threadIdx.x;
  if (tid == 0) {
    float xi[DOF];
    for (int i = 0; i < DOF; ++i) xi[i] = h.dof[i];
    se3_exp(xi, T);
    for (int i = 0; i < ROWS; ++i) h.Tc[i] = T[i];
    h.Tc[12] = h.Tc[13] = h.Tc[14] = 0.f;
    h.Tc[15] = 1.f;
  } else if (tid == 32) {  // another warp: the Jacobian beside the exponential
    float xi[DOF], J[ROWS * DOF];
    for (int i = 0; i < DOF; ++i) xi[i] = h.dof[i];
    se3_jacobian(xi, J);
    for (int i = 0; i < ROWS * DOF; ++i) h.jac[i] = J[i];
  }
  __syncthreads();
  const float kv[4] = {h.K[0], h.K[4], h.K[2], h.K[5]};  // fx fy cx cy
  for (int i = tid; i < h.B * 16; i += THREADS) {
    const int c = i % 16;
    h.cam[i] = c < ROWS ? T[c] : kv[c - ROWS];
  }
  if (h.probes)
    for (int p = tid; p < h.P; p += THREADS) project(T, h.probes + 3 * p, h.K, h.pix + 2 * p);
}

struct Grad {
  const float* parts;   // [B, nb, 12] K2b's (or K1b's) pose partials
  const float* lparts;  // [B, ns] the forward's loss partials
  const int* counts;    // [B, T] bin loads, or null (the dense route's K1f sums empty tiles)
  const float* ref_sq;  // [B, T] sum of ref^2 per tile
  const float* w;       // [B] frame weights
  const float* jac;     // [12, 6]
  float* scratch;       // [B * splits, 13]: a block's weighted loss and dL/dTc
  unsigned int* ticket; // [1], 0 between launches
  float* out;           // [7]: loss, g
  int B, nb, ns, T, splits;
};

// Fixed-order tree sum of n rows of THREADS values in shared memory (row r at
// sh + r * THREADS) into row element 0.
__device__ __forceinline__ void block_sums(float* sh, int n) {
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (threadIdx.x < s)
      for (int r = 0; r < n; ++r)
        sh[r * THREADS + threadIdx.x] += sh[r * THREADS + threadIdx.x + s];
  }
  __syncthreads();
}

// grid (splits, B): block (s, b) sums the s-th of `splits` interleaved slices
// of frame b (element i of a slice: s * THREADS + tid + k * splits * THREADS).
// The last block to finish sums the B * splits rows, each thread a fixed
// stride of them, then a fixed tree: the result depends on the shapes only.
__global__ void __launch_bounds__(THREADS) step_grad_kernel(Grad g) {
  constexpr int N = ROWS + 2;  // 12 pose partials, the loss, the empty tiles
  __shared__ float sh[N * THREADS];
  __shared__ bool last;
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int first = s * THREADS + tid, stride = g.splits * THREADS;
  float acc[N];
#pragma unroll
  for (int r = 0; r < N; ++r) acc[r] = 0.f;
  const float* pb = g.parts + (size_t)b * g.nb * ROWS;
#pragma unroll 2
  for (int c = first; c < g.nb; c += stride) {
    const float4* row = reinterpret_cast<const float4*>(pb + (size_t)c * ROWS);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 x = row[q];
      acc[4 * q] += x.x;
      acc[4 * q + 1] += x.y;
      acc[4 * q + 2] += x.z;
      acc[4 * q + 3] += x.w;
    }
  }
  const float* lb = g.lparts + (size_t)b * g.ns;
#pragma unroll 4
  for (int i = first; i < g.ns; i += stride) acc[ROWS] += lb[i];
  if (g.counts) {
    const int* cb = g.counts + (size_t)b * g.T;
    const float* rb = g.ref_sq + (size_t)b * g.T;
#pragma unroll 4
    for (int t = first; t < g.T; t += stride)
      acc[ROWS + 1] += cb[t] == 0 ? rb[t] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < N; ++r) sh[r * THREADS + tid] = acc[r];
  block_sums(sh, N);
  if (tid == 0) {
    float* row = g.scratch + ((size_t)b * g.splits + s) * (ROWS + 1);
    row[0] = g.w[b] * (sh[ROWS * THREADS] + sh[(ROWS + 1) * THREADS]);
    for (int r = 0; r < ROWS; ++r) row[1 + r] = sh[r * THREADS];
    __threadfence();  // the row is visible before the ticket counts it
    last = atomicAdd(g.ticket, 1u) == (unsigned)(g.B * g.splits) - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the rows (frame-major) in a fixed order
  const int rows = g.B * g.splits;
  float tot[ROWS + 1];
#pragma unroll
  for (int r = 0; r <= ROWS; ++r) tot[r] = 0.f;
  for (int f = tid; f < rows; f += THREADS) {
    const float* row = g.scratch + (size_t)f * (ROWS + 1);
#pragma unroll
    for (int r = 0; r <= ROWS; ++r) tot[r] += __ldcg(row + r);
  }
#pragma unroll
  for (int r = 0; r <= ROWS; ++r) sh[r * THREADS + tid] = tot[r];
  block_sums(sh, ROWS + 1);
  if (tid < DOF) {
    float x = 0.f;
    for (int r = 0; r < ROWS; ++r) x += g.jac[r * DOF + tid] * sh[(1 + r) * THREADS];
    g.out[1 + tid] = x;
  } else if (tid == DOF) {
    g.out[0] = sh[0];
    *g.ticket = 0u;
  }
}

struct Update {
  const float* gl;  // [7]: loss, g (before the division by den)
  float den;
  int adam;
  float b1, omb1, b2, omb2, eps, momentum, clip, clip_value, wd;
  const float* lr_ptr;  // a schedule's lr on the device, or null: lr
  float lr;
  int* count;    // adam's count (int32), or null
  float* mu;     // [6] adam's first moment, or sgd's trace
  float* nu;     // [6] adam's second moment, or null
  int* sched;    // the schedule's count (int32)
  float* dof;    // [6]
  float* losses; // [length]
  float* history;// [length, 6]
  long long* idx;
  const long long* inner;
  unsigned char* need;
  const float* probes;  // [P, 3], or null: the fixed cadence's flag
  const float* pix;     // [P, 2] the state's build pixels
  const float* K;       // [3, 3]
  float budget;
  int P;
};

__device__ __forceinline__ int inc(int c) { return c < INT_MAX ? c + 1 : c; }  // safe_increment

__global__ void __launch_bounds__(THREADS) step_update_kernel(Update u) {
  __shared__ float T[ROWS];
  __shared__ float red[THREADS];
  const int tid = threadIdx.x;
  if (tid == 0) {
    const long long i = *u.idx;
    const float loss = dvd(u.gl[0], u.den);
    float g[DOF], x[DOF];
    for (int k = 0; k < DOF; ++k) {
      g[k] = dvd(u.gl[1 + k], u.den);
      x[k] = u.dof[k];
    }
    if (u.clip > 0.f) {  // optax.clip_by_global_norm
      float s = 0.f;
      for (int k = 0; k < DOF; ++k) s = add(s, mul(g[k], g[k]));
      const float norm = __fsqrt_rn(s);
      if (!(norm < u.clip))
        for (int k = 0; k < DOF; ++k) g[k] = mul(dvd(g[k], norm), u.clip);
    }
    if (u.clip_value > 0.f)  // optax.clip; a NaN stays NaN
      for (int k = 0; k < DOF; ++k)
        g[k] = g[k] < -u.clip_value ? -u.clip_value : (g[k] > u.clip_value ? u.clip_value : g[k]);
    const float neg = -(u.lr_ptr ? *u.lr_ptr : u.lr);
    float upd[DOF];
    if (u.adam) {
      const int c = inc(*u.count);
      const float cf = (float)c;
      const float c1 = sub(1.f, powf(u.b1, cf)), c2 = sub(1.f, powf(u.b2, cf));
      for (int k = 0; k < DOF; ++k) {
        const float m = add(mul(u.omb1, g[k]), mul(u.b1, u.mu[k]));
        const float n = add(mul(u.omb2, mul(g[k], g[k])), mul(u.b2, u.nu[k]));
        float s = dvd(dvd(m, c1), add(__fsqrt_rn(dvd(n, c2)), u.eps));
        if (u.wd != 0.f) s = add(s, mul(u.wd, x[k]));
        upd[k] = mul(neg, s);
        u.mu[k] = m;
        u.nu[k] = n;
      }
      *u.count = c;
    } else {
      for (int k = 0; k < DOF; ++k) {
        const float tr = add(g[k], mul(u.momentum, u.mu[k]));
        upd[k] = mul(neg, tr);
        u.mu[k] = tr;
      }
    }
    *u.sched = inc(*u.sched);
    u.losses[i] = loss;
    for (int k = 0; k < DOF; ++k) {
      u.history[i * DOF + k] = x[k];  // the pose before the update
      x[k] = add(x[k], upd[k]);
      u.dof[k] = x[k];
    }
    *u.idx = i + 1;
    if (u.probes)
      se3_exp(x, T);
    else
      *u.need = (i + 1) % *u.inner == 0;
  }
  if (!u.probes) return;
  __syncthreads();
  float m = 0.f;
  for (int p = tid; p < u.P; p += THREADS) {
    float uv[2];
    project(T, u.probes + 3 * p, u.K, uv);
    m = nan_max(fabsf(uv[0] - u.pix[2 * p]), m);
    m = nan_max(fabsf(uv[1] - u.pix[2 * p + 1]), m);
  }
  red[tid] = m;
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (tid < s) red[tid] = nan_max(red[tid + s], red[tid]);
  }
  if (tid == 0) *u.need = red[0] > u.budget;
}

}  // namespace

extern "C" {

// dof [6], K [3, 3] f32 -> Tc [4, 4], cam [B, 16], jac [12, 6] f32 and, where
// probes [P, 3] is given, pix [P, 2]. Returns the launch's cudaError_t.
int easyhec_step_head(const float* dof, const float* K, float* Tc, float* cam, float* jac,
                      const float* probes, float* pix, int B, int P, void* stream) {
  if (B <= 0 || P < 0 || (probes && !pix)) return (int)cudaErrorInvalidValue;
  const Head h{dof, K, Tc, cam, jac, probes, pix, B, P};
  step_head_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(h);
  return (int)cudaGetLastError();
}

// parts [B, nb, 12], lparts [B, ns], counts [B, T] i32 and ref_sq [B, T] (or
// both null), w [B], jac [12, 6] -> out [7], each frame over `splits` blocks;
// scratch [B * splits, 13] and ticket [1] (zero on entry, left zero) are the
// kernel's. Returns the launch's cudaError_t.
int easyhec_step_grad(const float* parts, const float* lparts, const int* counts,
                      const float* ref_sq, const float* w, const float* jac, float* scratch,
                      unsigned int* ticket, float* out, int B, int nb, int ns, int T,
                      int splits, void* stream) {
  if (B <= 0 || B > 65535 || splits <= 0 || nb < 0 || ns < 0 ||
      (counts && (!ref_sq || T <= 0)))
    return (int)cudaErrorInvalidValue;
  const Grad g{parts, lparts, counts, ref_sq, w, jac, scratch, ticket, out, B, nb, ns, T,
               splits};
  step_grad_kernel<<<dim3(splits, B), THREADS, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// One optimizer step of the bare pose in place (see Update). Returns the
// launch's cudaError_t.
int easyhec_step_update(const float* gl, float den, int adam, float b1, float omb1, float b2,
                        float omb2, float eps, float momentum, float clip, float clip_value,
                        float wd, const float* lr_ptr, float lr, int* count, float* mu,
                        float* nu, int* sched, float* dof, float* losses, float* history,
                        long long* idx, const long long* inner, unsigned char* need,
                        const float* probes, const float* pix, const float* K, float budget,
                        int P, void* stream) {
  if ((adam && (!count || !nu)) || (probes && (!pix || !K || P <= 0)))
    return (int)cudaErrorInvalidValue;
  const Update u{gl, den, adam, b1, omb1, b2, omb2, eps, momentum, clip, clip_value, wd,
                 lr_ptr, lr, count, mu, nu, sched, dof, losses, history, idx, inner, need,
                 probes, pix, K, budget, P};
  step_update_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(u);
  return (int)cudaGetLastError();
}

}  // extern "C"
