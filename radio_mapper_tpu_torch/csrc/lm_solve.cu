// The batched Levenberg-Marquardt TDOA solve: every iteration of every
// problem in one launch.
//
// Replaces no Pallas kernel: the reference's LM is an XLA fori_loop
// (radio_mapper_tpu/solver.py::solve_tdoa_impl) that XLA compiles into one
// program on the TPU; eager PyTorch ran it as some 60 small launches an
// iteration, paced by the host. This is its counterpart on the card.
// Python wrapper: radio_mapper_tpu_torch/ops/cuda/lm_solve.py; the eager
// loop (radio_mapper_tpu_torch/solver.py::lm_loop) is its plain version.
//
// A problem is N's row n: receivers anchors[n] [B, 3], measurements dd[n]
// and w[n] [P] on the pairs (pair_i, pair_j) (shared by every problem),
// wsum[n] = sum(w[n]) + 1e-12 and the start x0[n]; it writes the final
// position x[n] and cost[n]. The arithmetic is the loop's, element by
// element, in float32: the receivers' distances and unit vectors (+ 1e-9),
// the residuals, g and H summed over the pairs and divided by wsum, the
// Marquardt damping lam*max(diag, 1e-6) + 1e-6, the Cramer solve with its
// 1e-20 floor, Up frozen by a 0 mask when solving in 2-D, the step taken on
// cost_new < cost, lam *0.3 or *3 clamped to [1e-8, 1e8], cost =
// min(cost, cost_new). Each product, sum and quotient is rounded on its own
// (__fmul_rn, __fadd_rn, ...: no contraction into FMAs), as the loop's
// separate kernels round them; the loop's einsums take their sums in
// cuBLAS's order, so the two agree to float32 rounding, not bit for bit.
// radio_mapper_tpu_torch/testing.py::lm_emulate takes the kernel's order
// in numpy float32, and the card tests hold the kernel to it bit for bit.
// NaN goes where the loop takes it: min and clamp propagate it, a NaN
// comparison keeps the old value, and the start and lam carry 0 * dd[0].
//
// Two layouts, picked by the wrapper from P and B (lm_solve.layout):
//
//   thread  P <= 64 and B <= 16 (every all-pairs network up to 11
//           receivers: the flagship's and narrowband's 8 give P = 28): one
//           thread a problem, 32 problems a block (31 KB of shared
//           memory at the limits, which bound it). The block stages each
//           thread's anchors, dd and w in shared memory ([k][thread]: a
//           warp's loads are conflict-free) and the pairs' indices once;
//           each pass puts a thread's receivers' distance and unit vector
//           there too, then sums the pairs in index order. Measured on an
//           H100 (80GB HBM3, 700 W; both layouts at P = 28, B = 8, 40
//           iterations, mean of 20 back to back): at the flagship's
//           16,384 problems 0.306 ms against the warp layout's 0.777 ms,
//           whose lanes hold one pair each and pay 13 cross-lane sums of
//           5 shuffles twice an iteration; at narrowband's 1,024 problems
//           0.301 ms against 0.132 ms (32 warps on 132 SMs: each problem's
//           dependent chain sets the time), 0.05% of its dispatch.
//   warp    above (64 receivers: P = 2016): one warp a problem, 4 a block.
//           Lanes compute receivers r = lane, lane + 32, ... into shared
//           memory, sum the pairs p = lane, lane + 32, ... read coalesced
//           from device memory, and all-reduce the 13 sums by xor
//           shuffles, which leave every lane the same bits (a + b = b + a),
//           so every lane takes the same step and no broadcast is needed.
//
// What bounds it on the H100: the chain of dependent float operations of
// one problem (two passes over the pairs, one 3x3 solve and about 2*B
// square roots and 6*B divisions an iteration), not bytes: the flagship's
// 16,384 problems read 3.7 MB once and do ~1 GFLOP in all.

#include <cuda_runtime.h>

namespace {

constexpr int THREAD_MAX_PAIRS = 64;      // lm_solve.THREAD_MAX_PAIRS
constexpr int THREAD_MAX_RECEIVERS = 16;  // lm_solve.THREAD_MAX_RECEIVERS
constexpr int TPB = 32;                   // thread layout: problems a block
constexpr int WARPS = 4;                  // warp layout: problems a block

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ bool is_nan(float a) { return a != a; }

// Where one problem's data lies for its layout. Thread layout: shared
// memory, element k of the problem at [k * stride]; warp layout: device
// memory, stride 1, and the receivers' cache in the warp's shared memory.
struct Problem {
  const float* anc;  // [B * 3] at stride
  const float* dd;   // [P] at stride
  const float* w;    // [P] at stride
  const int2* pairs; // [P]
  float4* rc;        // [B] at stride: distance and unit vector at the current point
  int stride;
  int b, p;
  float wsum, m2;    // m2: the Up component's mask (0 in 2-D)
};

template <bool WARP>
__device__ __forceinline__ float all_sum(float v) {
  if (WARP) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// The receivers' ‖x − a‖ and (x − a) / (‖x − a‖ + 1e-9) into the cache.
template <bool WARP>
__device__ __forceinline__ void receivers(const Problem& q, const float x[3], int lane) {
  if (WARP) __syncwarp();  // every lane is done reading the last pass's cache
  for (int r = WARP ? lane : 0; r < q.b; r += WARP ? 32 : 1) {
    const float d0 = sub(x[0], q.anc[(3 * r + 0) * q.stride]);
    const float d1 = sub(x[1], q.anc[(3 * r + 1) * q.stride]);
    const float d2 = sub(x[2], q.anc[(3 * r + 2) * q.stride]);
    const float dist = __fsqrt_rn(add(add(mul(d0, d0), mul(d1, d1)), mul(d2, d2)));
    const float den = add(dist, 1e-9f);
    q.rc[r * q.stride] = make_float4(dist, quo(d0, den), quo(d1, den), quo(d2, den));
  }
  if (WARP) __syncwarp();
}

// sum_p w r^2 / wsum at x.
template <bool WARP>
__device__ float cost_at(const Problem& q, const float x[3], int lane) {
  receivers<WARP>(q, x, lane);
  float c = 0.f;
#pragma unroll 4
  for (int k = WARP ? lane : 0; k < q.p; k += WARP ? 32 : 1) {
    const int2 ij = q.pairs[k];
    const float r = sub(sub(q.rc[ij.x * q.stride].x, q.rc[ij.y * q.stride].x), q.dd[k * q.stride]);
    c = add(c, mul(mul(q.w[k * q.stride], r), r));
  }
  return quo(all_sum<WARP>(c), q.wsum);
}

// g = J^T W r and H = J^T W J at x, each over wsum (h row-major, 9).
template <bool WARP>
__device__ void normal_equations(const Problem& q, const float x[3], int lane, float g[3], float h[9]) {
  receivers<WARP>(q, x, lane);
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = 0.f;
  const float m[3] = {1.f, 1.f, q.m2};
#pragma unroll 2
  for (int k = WARP ? lane : 0; k < q.p; k += WARP ? 32 : 1) {
    const int2 ij = q.pairs[k];
    const float4 ri = q.rc[ij.x * q.stride];
    const float4 rj = q.rc[ij.y * q.stride];
    const float wk = q.w[k * q.stride];
    const float r = sub(sub(ri.x, rj.x), q.dd[k * q.stride]);
    const float jac[3] = {mul(sub(ri.y, rj.y), m[0]), mul(sub(ri.z, rj.z), m[1]), mul(sub(ri.w, rj.w), m[2])};
    const float wr = mul(wk, r);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = add(g[i], mul(jac[i], wr));
#pragma unroll
      for (int l = 0; l < 3; ++l) h[3 * i + l] = add(h[3 * i + l], mul(jac[i], mul(jac[l], wk)));
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i] = quo(all_sum<WARP>(g[i]), q.wsum);
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = quo(all_sum<WARP>(h[i]), q.wsum);
}

// a s = b for a 3x3 a (row-major) by its adjugate, |det| floored at 1e-20.
__device__ __forceinline__ void solve3(const float a[9], const float b[3], float s[3]) {
  const float c00 = sub(mul(a[4], a[8]), mul(a[5], a[7]));
  const float c01 = sub(mul(a[5], a[6]), mul(a[3], a[8]));
  const float c02 = sub(mul(a[3], a[7]), mul(a[4], a[6]));
  float det = add(add(mul(a[0], c00), mul(a[1], c01)), mul(a[2], c02));
  det = fabsf(det) < 1e-20f ? 1e-20f : det;
  const float inv = quo(1.0f, det);
  const float c10 = sub(mul(a[2], a[7]), mul(a[1], a[8]));
  const float c11 = sub(mul(a[0], a[8]), mul(a[2], a[6]));
  const float c12 = sub(mul(a[1], a[6]), mul(a[0], a[7]));
  const float c20 = sub(mul(a[1], a[5]), mul(a[2], a[4]));
  const float c21 = sub(mul(a[2], a[3]), mul(a[0], a[5]));
  const float c22 = sub(mul(a[0], a[4]), mul(a[1], a[3]));
  s[0] = mul(add(add(mul(c00, b[0]), mul(c10, b[1])), mul(c20, b[2])), inv);
  s[1] = mul(add(add(mul(c01, b[0]), mul(c11, b[1])), mul(c21, b[2])), inv);
  s[2] = mul(add(add(mul(c02, b[0]), mul(c12, b[1])), mul(c22, b[2])), inv);
}

template <bool WARP>
__device__ void solve_problem(const Problem& q, const float* x0, int iterations, int lane, float* x_out,
                              float* cost_out) {
  float x[3] = {x0[0], x0[1], x0[2]};
  const float m[3] = {1.f, 1.f, q.m2};
  float lam = add(1e-3f, mul(0.0f, q.dd[0]));
  float cost = cost_at<WARP>(q, x, lane);
  for (int it = 0; it < iterations; ++it) {
    float g[3], h[9];
    normal_equations<WARP>(q, x, lane, g, h);
    float damp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float d = h[4 * i];
      damp[i] = add(mul(lam, d < 1e-6f ? 1e-6f : d), 1e-6f);  // NaN stays NaN, as clamp
    }
    float a[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int l = 0; l < 3; ++l) a[3 * i + l] = add(h[3 * i + l], mul(i == l ? 1.f : 0.f, damp[l]));
    }
    const float b[3] = {-g[0], -g[1], -g[2]};
    float s[3];
    solve3(a, b, s);
    float xn[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) xn[i] = add(x[i], mul(s[i], m[i]));
    const float cn = cost_at<WARP>(q, xn, lane);
    const bool improved = cn < cost;
    if (improved) {
#pragma unroll
      for (int i = 0; i < 3; ++i) x[i] = xn[i];
    }
    lam = improved ? mul(lam, 0.3f) : mul(lam, 3.0f);
    lam = lam < 1e-8f ? 1e-8f : (lam > 1e8f ? 1e8f : lam);
    cost = (is_nan(cost) || is_nan(cn)) ? __int_as_float(0x7fc00000) : (cn < cost ? cn : cost);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) x_out[i] = x[i];
    *cost_out = cost;
  }
}

// Thread layout. Shared memory: rc [B][TPB] float4, anchors [3B][TPB],
// dd [P][TPB], w [P][TPB], pairs [P] int2.
__global__ void __launch_bounds__(TPB)
lm_thread_kernel(const float* __restrict__ anchors, const float* __restrict__ dd, const float* __restrict__ w,
                 const float* __restrict__ wsum, const float* __restrict__ x0, const int2* __restrict__ pairs,
                 float* __restrict__ x_out, float* __restrict__ cost_out, int n, int b, int p, int iterations,
                 float m2) {
  extern __shared__ float4 smem[];
  float* s_anc = reinterpret_cast<float*>(smem + b * TPB);
  float* s_dd = s_anc + 3 * b * TPB;
  float* s_w = s_dd + p * TPB;
  int2* s_pairs = reinterpret_cast<int2*>(s_w + p * TPB);
  const int t = threadIdx.x;
  for (int k = t; k < p; k += TPB) s_pairs[k] = pairs[k];
  const int prob = blockIdx.x * TPB + t;
  if (prob < n) {
    for (int k = 0; k < 3 * b; ++k) s_anc[k * TPB + t] = anchors[static_cast<size_t>(prob) * 3 * b + k];
    for (int k = 0; k < p; ++k) {
      s_dd[k * TPB + t] = dd[static_cast<size_t>(prob) * p + k];
      s_w[k * TPB + t] = w[static_cast<size_t>(prob) * p + k];
    }
  }
  __syncthreads();
  if (prob >= n) return;
  const Problem q{s_anc + t, s_dd + t, s_w + t, s_pairs, smem + t, TPB, b, p, wsum[prob], m2};
  solve_problem<false>(q, x0 + 3 * static_cast<size_t>(prob), iterations, 0, x_out + 3 * static_cast<size_t>(prob),
                       cost_out + prob);
}

// Warp layout. Shared memory: rc [WARPS][B] float4.
__global__ void __launch_bounds__(WARPS * 32)
lm_warp_kernel(const float* __restrict__ anchors, const float* __restrict__ dd, const float* __restrict__ w,
               const float* __restrict__ wsum, const float* __restrict__ x0, const int2* __restrict__ pairs,
               float* __restrict__ x_out, float* __restrict__ cost_out, int n, int b, int p, int iterations,
               float m2) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t prob = static_cast<size_t>(blockIdx.x) * WARPS + warp;
  if (prob >= static_cast<size_t>(n)) return;  // the whole warp
  const Problem q{anchors + prob * 3 * b, dd + prob * p, w + prob * p, pairs, smem + warp * b, 1, b, p, wsum[prob], m2};
  solve_problem<true>(q, x0 + 3 * prob, iterations, lane, x_out + 3 * prob, cost_out + prob);
}

}  // namespace

// x [n, 3] and cost [n] of n problems: anchors [n, b, 3], dd and w [n, p],
// wsum [n], x0 [n, 3], pairs [p] (i, j) int32 in [0, b); warp_layout 0 or 1
// as lm_solve.layout picks.
extern "C" int rm_lm_solve(const float* anchors, const float* dd, const float* w, const float* wsum, const float* x0,
                           const int* pairs, float* x_out, float* cost_out, int n, int b, int p, int iterations,
                           int solve_2d, int warp_layout, cudaStream_t stream) {
  if (n <= 0 || b < 1 || p < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float m2 = solve_2d ? 0.f : 1.f;
  const int2* pr = reinterpret_cast<const int2*>(pairs);
  if (!warp_layout) {
    if (p > THREAD_MAX_PAIRS || b > THREAD_MAX_RECEIVERS) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(b) * TPB * sizeof(float4) +
                        static_cast<size_t>(3 * b + 2 * p) * TPB * sizeof(float) + static_cast<size_t>(p) * sizeof(int2);
    lm_thread_kernel<<<(n + TPB - 1) / TPB, TPB, smem, stream>>>(anchors, dd, w, wsum, x0, pr, x_out, cost_out, n, b,
                                                                 p, iterations, m2);
  } else {
    const size_t smem = static_cast<size_t>(WARPS) * b * sizeof(float4);
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(lm_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    lm_warp_kernel<<<(n + WARPS - 1) / WARPS, WARPS * 32, smem, stream>>>(anchors, dd, w, wsum, x0, pr, x_out,
                                                                          cost_out, n, b, p, iterations, m2);
  }
  return static_cast<int>(cudaGetLastError());
}
