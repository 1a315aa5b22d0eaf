// Kernel K1: forward CT-order four-step FFT + spectral detection, one
// thread block per row.
//
// Replaces radio_mapper_tpu/ops/pallas/detect_kernel.py::fft_detect_rows_ct
// (fft_kernel.ct_fft_core + detect_kernel._detect_body). Python wrapper and
// plain PyTorch version: radio_mapper_tpu_torch/ops/cuda/fft_detect.py.
//
// The whole row lives in shared memory (n float2, 139,264 B at n = 17408)
// and the two DFT stages of ct_dft.cuh (shared with kernel K3) run on it
// in place; see that header for the CT layout.
//
// Bound on the H100: the direct DFT stages, n*(n1+n2) complex FMAs per row,
// issued from shared memory and L1 on the FP32 CUDA cores. Later PRs: the
// DFT stages on tensor cores, TMA row loads, fusion with kernel K2.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "ct_dft.cuh"

namespace {

constexpr int K1_THREADS = 512;            // fft_detect.THREADS
constexpr int K1_WARPS = K1_THREADS / 32;
constexpr int K1_MAX_KJ = 16;              // inner DFT: n2 <= K1_WARPS * K1_MAX_KJ = 256
constexpr int K1_RJ = 8;                   // outer DFT: rows per thread per chunk
constexpr int K1_MAX_PER_THREAD = 48;      // n <= K1_THREADS * 48 = 24576
constexpr int SEG = 8;                     // natural bins per detection segment
constexpr float LN10_OVER_10 = 0.23025850929940458f;

struct DetectParams {
  int radius;      // +/- sliding-max half-width, natural bins
  int keep_lo;     // DC-notch keep range, natural bins, inclusive
  int keep_hi;
  float thr_lin;   // linear-power height threshold
  int has_conf;    // confidence gate on/off
  float conf_cs;   // confidence_floor * snr_fullscale_db
  float off;       // power_offset_db
  int bisect_iters;
};

struct MaxOp { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct MinOp { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct SumOp { __device__ int operator()(int a, int b) const { return a + b; } };

// Every thread returns the block-wide reduction (same value, same order).
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = scratch[0];
  for (int w = 1; w < K1_WARPS; ++w) r = op(r, scratch[w]);
  __syncthreads();  // scratch may be reused
  return r;
}

__global__ void __launch_bounds__(K1_THREADS, 1)
fft_detect_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                  const float2* __restrict__ w1, const float2* __restrict__ w2,
                  const float2* __restrict__ tw,
                  float* __restrict__ fre, float* __restrict__ fim,
                  float* __restrict__ seg_score, float* __restrict__ seg_arg,
                  float* __restrict__ nf_out, float* __restrict__ rmax_out,
                  int n1, int n2, DetectParams prm) {
  extern __shared__ float2 xs[];  // [n] complex row, CT layout
  __shared__ float red_f[K1_WARPS];
  __shared__ int red_i[K1_WARPS];

  const int n = n1 * n2;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* xr = xre + row * n;
  const float* xi = xim + row * n;

  for (int m = tid; m < n; m += K1_THREADS) xs[m] = make_float2(xr[m], xi[m]);
  __syncthreads();

  rm_ct::inner_dft<K1_THREADS, K1_MAX_KJ>(xs, w2, tw, n1, n2);
  rm_ct::outer_dft<K1_THREADS, K1_RJ>(xs, w1, n1, n2);

  // ---- write the spectra once; keep each thread's power values in
  // registers while the shared buffer is re-purposed as power + scratch.
  float* fr = fre + row * n;
  float* fi = fim + row * n;
  float pv[K1_MAX_PER_THREAD];
  float vmax = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < K1_MAX_PER_THREAD; ++j) {
    const int m = tid + K1_THREADS * j;
    if (m < n) {
      const float2 v = xs[m];
      fr[m] = v.x;
      fi[m] = v.y;
      pv[j] = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
      vmax = fmaxf(vmax, pv[j]);
    }
  }
  __syncthreads();
  float* pwr = reinterpret_cast<float*>(xs);  // [n] linear power, CT order
  float* aux = pwr + n;                       // [n] scratch
#pragma unroll
  for (int j = 0; j < K1_MAX_PER_THREAD; ++j) {
    const int m = tid + K1_THREADS * j;
    if (m < n) pwr[m] = pv[j];
  }
  const float row_max = block_reduce(vmax, MaxOp(), red_f);  // syncs: pwr visible

  // ---- noise floor: 24-step dB bisection over the stride-8 natural
  // subsample, which is the CT rows k2 = 0 (mod 8).
  const int s = n / SEG;
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (int i = tid; i < s; i += K1_THREADS) {
    const int b2 = i / n1, k1 = i - b2 * n1;
    const float p = pwr[(SEG * b2) * n1 + k1];
    const float db = __fadd_rn(__fmul_rn(10.f, log10f(__fadd_rn(p, 1e-24f))), prm.off);
    aux[i] = db;
    lo = fminf(lo, db);
    hi = fmaxf(hi, db);
  }
  lo = block_reduce(lo, MinOp(), red_f);
  hi = block_reduce(hi, MaxOp(), red_f);
  for (int it = 0; it < prm.bisect_iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (int i = tid; i < s; i += K1_THREADS) c += (aux[i] <= mid) ? 1 : 0;
    c = block_reduce(c, SumOp(), red_i);
    if (2 * c < s) lo = mid; else hi = mid;
  }
  const float nf = __fmul_rn(0.5f, __fadd_rn(lo, hi));
  const float conf_lin =
      prm.has_conf ? expf(__fmul_rn(__fadd_rn(__fsub_rn(nf, prm.off), prm.conf_cs), LN10_OVER_10))
                   : 0.f;

  // ---- candidacy: circular +/-radius sliding max in natural bin order
  // (natural k = k2 + n2 k1 sits at CT address k2 n1 + k1), then gates.
  for (int m = tid; m < n; m += K1_THREADS) {
    const int k2 = m / n1, k1 = m - k2 * n1;
    const int k = k2 + n2 * k1;
    const float p = pwr[m];
    float mx = p;
    for (int d = -prm.radius; d <= prm.radius; ++d) {
      int a2 = k2 + d, a1 = k1;  // |d| <= n2: one carry at most
      if (a2 < 0) { a2 += n2; a1 = (a1 == 0) ? n1 - 1 : a1 - 1; }
      else if (a2 >= n2) { a2 -= n2; a1 = (a1 == n1 - 1) ? 0 : a1 + 1; }
      mx = fmaxf(mx, pwr[a2 * n1 + a1]);
    }
    const float pe = __fadd_rn(p, 1e-24f);
    bool cand = (p >= mx) && (pe > prm.thr_lin) && (k >= prm.keep_lo) && (k <= prm.keep_hi);
    if (prm.has_conf) cand = cand && (pe >= conf_lin);
    aux[m] = cand ? p : -CUDART_INF_F;
  }
  __syncthreads();

  // ---- per-segment (max, lowest in-segment argmax): segment f = b2 n1 + k1
  // is the 8 CT rows 8 b2 .. 8 b2 + 7 of column k1.
  float* sc = seg_score + row * s;
  float* sa = seg_arg + row * s;
  for (int f = tid; f < s; f += K1_THREADS) {
    const int b2 = f / n1, k1 = f - b2 * n1;
    const float* v = aux + (SEG * b2) * n1 + k1;
    float best = v[0];
#pragma unroll
    for (int o = 1; o < SEG; ++o) best = fmaxf(best, v[o * n1]);
    int arg = SEG;
#pragma unroll
    for (int o = SEG - 1; o >= 0; --o) arg = (v[o * n1] >= best) ? o : arg;
    sc[f] = best;
    sa[f] = static_cast<float>(arg);
  }
  if (tid == 0) {
    nf_out[row] = nf;
    rmax_out[row] = row_max;
  }
}

}  // namespace

extern "C" int rm_fft_detect_rows_ct(
    const float* xre, const float* xim, const float2* w1, const float2* w2, const float2* tw,
    float* fre, float* fim, float* seg_score, float* seg_arg, float* nf, float* rmax,
    int rows, int n1, int n2, int radius, int keep_lo, int keep_hi,
    float thr_lin, int has_conf, float conf_cs, float off, int bisect_iters,
    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n1) * n2 * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      fft_detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const DetectParams prm{radius, keep_lo, keep_hi, thr_lin, has_conf, conf_cs, off, bisect_iters};
  fft_detect_kernel<<<rows, K1_THREADS, smem, stream>>>(
      xre, xim, w1, w2, tw, fre, fim, seg_score, seg_arg, nf, rmax, n1, n2, prm);
  return static_cast<int>(cudaGetLastError());
}
