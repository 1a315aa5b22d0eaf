// Shared device code: the spectral detect epilogue of kernels K1, K4 and K8
// on one row's linear power array in shared memory, and its parts.
//
// The body of radio_mapper_tpu/ops/pallas/detect_kernel.py::_detect_body:
// the row max, the 24-step dB bisection noise floor over the stride-8
// natural subsample, the circular +/-radius sliding max in natural bin
// order, the gates, and the per-8-bin-segment (max, lowest argmax)
// partials; with emit_topk = K (K1 and K4, not K8) the K masked-argmax
// passes over those partials (block_topk) instead of writing them. K1
// (fft_detect.cu) runs it on the spectra it has just transformed and K8
// (channel_step.cu) inside the per-channel megakernel;
// K4 (detect_ct.cu) runs its parts (power, sub_db, bisect_floor,
// conf_level, candidate, segment_partial) on column tiles of spectra read
// from memory, so it takes rows that do not fit shared memory. Every
// reduction is a max, a min or an integer count, so the same float inputs
// give the same outputs bit for bit in all three.
//
// CT layout: the power of natural bin k = k2 + n2*k1 sits at m = k2*n1 + k1.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace rm_det {

constexpr int SEG = 8;  // natural bins per detection segment
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
struct IntMinOp { __device__ int operator()(int a, int b) const { return min(a, b); } };

constexpr int TOPK_LANES = 128;  // the emit_topk output block: [rows, 128]

// Every thread returns the block-wide reduction (same value, same order).
template <int THREADS, typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = scratch[0];
  for (int w = 1; w < THREADS / 32; ++w) r = op(r, scratch[w]);
  __syncthreads();  // scratch may be reused
  return r;
}

// Linear power of one bin (the expression every kernel uses).
__device__ __forceinline__ float power(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

// A power in dB, plus the power offset: the noise floor's scale.
__device__ __forceinline__ float sub_db(float p, const DetectParams& prm) {
  return __fadd_rn(__fmul_rn(10.f, log10f(__fadd_rn(p, 1e-24f))), prm.off);
}

// The noise floor: bisection of [lo, hi] (the block's min and max of aux)
// over the s dB values aux[0..s) in shared memory, which every thread has
// written before the reductions that gave lo and hi.
template <int THREADS>
__device__ float bisect_floor(const float* aux, int s, float lo, float hi, const DetectParams& prm,
                              int* red_i) {
  const int tid = threadIdx.x;
  for (int it = 0; it < prm.bisect_iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (int i = tid; i < s; i += THREADS) c += (aux[i] <= mid) ? 1 : 0;
    c = block_reduce<THREADS>(c, SumOp(), red_i);
    if (2 * c < s) lo = mid; else hi = mid;
  }
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// The confidence gate's linear power for noise floor nf (0 without a gate).
__device__ __forceinline__ float conf_level(float nf, const DetectParams& prm) {
  return prm.has_conf ? expf(__fmul_rn(__fadd_rn(__fsub_rn(nf, prm.off), prm.conf_cs), LN10_OVER_10)) : 0.f;
}

// The gates on bin k of power p whose +/-radius window max is mx: its
// score, -inf where it is no candidate.
__device__ __forceinline__ float candidate(float p, float mx, int k, const DetectParams& prm, float conf_lin) {
  const float pe = __fadd_rn(p, 1e-24f);
  bool cand = (p >= mx) && (pe > prm.thr_lin) && (k >= prm.keep_lo) && (k <= prm.keep_hi);
  if (prm.has_conf) cand = cand && (pe >= conf_lin);
  return cand ? p : -CUDART_INF_F;
}

// One segment's (max, lowest in-segment argmax) over the 8 scores
// v[0], v[stride], ..., v[7*stride] (8 consecutive natural bins).
__device__ __forceinline__ void segment_partial(const float* v, int stride, float* sc, float* sa) {
  float best = v[0];
#pragma unroll
  for (int o = 1; o < SEG; ++o) best = fmaxf(best, v[o * stride]);
  int arg = SEG;
#pragma unroll
  for (int o = SEG - 1; o >= 0; --o) arg = (v[o * stride] >= best) ? o : arg;
  *sc = best;
  *sa = static_cast<float>(arg);
}

// Detect one row. pwr: [n] linear power, CT order; aux: [n] scratch; both
// in shared memory. Every thread of the block calls it once it has
// written its share of pwr. Writes the n/8 partials to sc (score, -inf
// where a segment holds no candidate) and sa (in-segment offset 0-7) and
// returns (noise floor in dB, row max of pwr) to every thread.
template <int THREADS>
__device__ float2 detect_row(const float* pwr, float* aux, int n1, int n2, const DetectParams& prm,
                             float* __restrict__ sc, float* __restrict__ sa) {
  __shared__ float red_f[THREADS / 32];
  __shared__ int red_i[THREADS / 32];
  const int n = n1 * n2;
  const int tid = threadIdx.x;
  __syncthreads();  // every thread's share of pwr is visible

  float vmax = -CUDART_INF_F;
  for (int m = tid; m < n; m += THREADS) vmax = fmaxf(vmax, pwr[m]);
  const float row_max = block_reduce<THREADS>(vmax, MaxOp(), red_f);

  // ---- noise floor: 24-step dB bisection over the stride-8 natural
  // subsample, which is the CT rows k2 = 0 (mod 8).
  const int s = n / SEG;
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (int i = tid; i < s; i += THREADS) {
    const int b2 = i / n1, k1 = i - b2 * n1;
    const float db = sub_db(pwr[(SEG * b2) * n1 + k1], prm);
    aux[i] = db;
    lo = fminf(lo, db);
    hi = fmaxf(hi, db);
  }
  lo = block_reduce<THREADS>(lo, MinOp(), red_f);
  hi = block_reduce<THREADS>(hi, MaxOp(), red_f);
  const float nf = bisect_floor<THREADS>(aux, s, lo, hi, prm, red_i);
  const float conf_lin = conf_level(nf, prm);

  // ---- candidacy: circular +/-radius sliding max in natural bin order
  // (natural k = k2 + n2 k1 sits at CT address k2 n1 + k1), then gates.
  for (int m = tid; m < n; m += THREADS) {
    const int k2 = m / n1, k1 = m - k2 * n1;
    const float p = pwr[m];
    float mx = p;
    for (int d = -prm.radius; d <= prm.radius; ++d) {
      int a2 = k2 + d, a1 = k1;  // |d| <= n2: one carry at most
      if (a2 < 0) { a2 += n2; a1 = (a1 == 0) ? n1 - 1 : a1 - 1; }
      else if (a2 >= n2) { a2 -= n2; a1 = (a1 == n1 - 1) ? 0 : a1 + 1; }
      mx = fmaxf(mx, pwr[a2 * n1 + a1]);
    }
    aux[m] = candidate(p, mx, k2 + n2 * k1, prm, conf_lin);
  }
  __syncthreads();

  // ---- per-segment (max, lowest in-segment argmax): segment f = b2 n1 + k1
  // is the 8 CT rows 8 b2 .. 8 b2 + 7 of column k1.
  for (int f = tid; f < s; f += THREADS) {
    const int b2 = f / n1, k1 = f - b2 * n1;
    segment_partial(aux + (SEG * b2) * n1 + k1, n1, sc + f, sa + f);
  }
  return make_float2(nf, row_max);
}

// The in-kernel top-K (detect_kernel._detect_body with emit_topk = k):
// k passes over the s segment partials, each a block max m of work, then
// the lowest index sel holding it (s where none does), as safe.top_k picks
// (an all -inf row picks 0). Lane j < k of the outputs gets m and the
// packed 8*sel + arg[sel] (exact in float32 below 2^24); work[sel] becomes
// -inf; lanes k .. 127 get 0. work: the scores in shared memory
// (overwritten); arg: the in-segment offsets (shared, or device memory this
// block wrote before a barrier). Every thread of the block calls it after
// a barrier that follows the last write of work and arg.
template <int THREADS>
__device__ void block_topk(float* work, const float* arg, int s, int k, float* __restrict__ vals,
                           float* __restrict__ packed) {
  __shared__ float red_f[THREADS / 32];
  __shared__ int red_i[THREADS / 32];
  const int tid = threadIdx.x;
  for (int j = 0; j < k; ++j) {
    float vmax = -CUDART_INF_F;
    for (int f = tid; f < s; f += THREADS) vmax = fmaxf(vmax, work[f]);
    const float m = block_reduce<THREADS>(vmax, MaxOp(), red_f);
    int first = s;
    for (int f = tid; f < s; f += THREADS) first = (work[f] >= m) ? min(first, f) : first;
    const int sel = block_reduce<THREADS>(first, IntMinOp(), red_i);
    if (tid == 0) {
      const float off = sel < s ? arg[sel] : 0.f;
      vals[j] = m;
      packed[j] = __fadd_rn(__fmul_rn(8.f, static_cast<float>(sel)), off);
      if (sel < s) work[sel] = -CUDART_INF_F;
    }
    __syncthreads();  // work[sel] is -inf for every thread's next pass
  }
  for (int j = k + tid; j < TOPK_LANES; j += THREADS) {
    vals[j] = 0.f;
    packed[j] = 0.f;
  }
}

}  // namespace rm_det
