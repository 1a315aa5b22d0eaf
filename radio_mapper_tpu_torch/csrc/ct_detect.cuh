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
// The cluster designs of K1 (fft_detect_cluster.cuh at n1 = 384, 640,
// 896; fft_rows_ct_cluster.cu at n1 = 128, 256) share the parts after
// those: subsample_floor (the floor from one order statistic,
// floor_select, on the block that holds the stride-8 subsample),
// pull_natural (a block's detect columns in natural order with circular
// halos, from wherever each CT row's power lies: the Src argument),
// window_partials (the float4 sliding max, the gates but the confidence
// gate, the lane-pair segment partials) and gate_partials (the
// confidence gate on each segment's best, and the stores).
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


// ---- the cluster designs' detect half -----------------------------------

constexpr int FLOOR_NB = 1024;  // floor_select's histogram buckets

// The noise floor as bisect_floor computes it, from one order statistic:
// a bisection step asks whether 2*count(aux <= mid) < s, that is whether
// fewer than k = (s + 1)/2 values are <= mid: mid < T for T the k-th
// smallest value (true as well where mid is NaN or fewer than k values
// are not NaN). A histogram of [lo, hi] in FLOOR_NB buckets (a monotone
// map) finds T's bucket, a second pass collects that bucket's values and
// each thread ranks one; the bisect_iters steps then run on T alone. A
// bucket of more than THREADS values (a row of equal powers) takes
// bisect_floor itself. hist: FLOOR_NB ints, cand: THREADS floats of
// shared memory, red: THREADS/32 ints.
template <int THREADS>
__device__ float floor_select(const float* aux, int s, float lo, float hi, const DetectParams& prm, int* hist,
                              float* cand, int* red) {
  constexpr int NB = FLOOR_NB, CAND = THREADS, WARPS = THREADS / 32;
  __shared__ int sel[3];  // T's bucket (-1: fewer than k values), T's rank in it, the values collected
  __shared__ float t_val;
  constexpr int PER = NB / THREADS;
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const int k = (s + 1) / 2;
  const float scale = hi > lo ? static_cast<float>(NB) / (hi - lo) : 0.f;
  const auto bucket = [&](float v) { return min(NB - 1, static_cast<int>(__fmul_rn(__fsub_rn(v, lo), scale))); };
  const auto mid = [](float a, float b) { return __fmul_rn(0.5f, __fadd_rn(a, b)); };
  for (int b = tid; b < NB; b += THREADS) hist[b] = 0;
  if (tid == 0) sel[2] = 0;
  __syncthreads();
  for (int i = tid; i < s; i += THREADS) {
    const float v = aux[i];
    if (v == v) atomicAdd(&hist[bucket(v)], 1);
  }
  __syncthreads();
  int loc[PER], sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    loc[j] = hist[tid * PER + j];
    sum += loc[j];
  }
  int inc = sum;  // inclusive scan over the warp, then over the warps
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int t = red[w];
    before += w < warp ? t : 0;
    total += t;
  }
  int c = before + inc - sum;  // values in the buckets before this thread's
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (c <= k - 1 && k - 1 < c + loc[j] && total >= k) {
      sel[0] = tid * PER + j;
      sel[1] = k - 1 - c;
    }
    c += loc[j];
  }
  if (tid == 0 && total < k) sel[0] = -1;
  __syncthreads();
  const int bstar = sel[0];
  if (bstar < 0) {  // every step is below
    for (int it = 0; it < prm.bisect_iters; ++it) lo = mid(lo, hi);
    return mid(lo, hi);
  }
  for (int i = tid; i < s; i += THREADS) {
    const float v = aux[i];
    if (v == v && bucket(v) == bstar) {
      const int j = atomicAdd(&sel[2], 1);
      if (j < CAND) cand[j] = v;
    }
  }
  __syncthreads();
  const int m = sel[2];
  if (m > CAND) return bisect_floor<THREADS>(aux, s, lo, hi, prm, red);
  if (tid < m) {  // value tid's rank among the bucket's (ties by index): one holds rank sel[1]
    const float cj = cand[tid];
    int rank = 0;
    for (int i = 0; i < m; ++i) {
      const float ci = cand[i];
      rank += (ci < cj || (ci == cj && i < tid)) ? 1 : 0;
    }
    if (rank == sel[1]) t_val = cj;
  }
  __syncthreads();
  const float t = t_val;
  for (int it = 0; it < prm.bisect_iters; ++it) {
    const float m0 = mid(lo, hi);
    if (m0 != m0 || m0 < t) lo = m0; else hi = m0;
  }
  return mid(lo, hi);
}

// The noise floor of a row whose stride-8 subsample (the CT rows k2 = 0
// mod 8) is the s powers sub[0..s) in shared memory: their dB values to
// aux (s floats, then floor_select's histogram and bucket: s + FLOOR_NB +
// THREADS floats of shared memory), the block's min and max of them, then
// floor_select. Returns the floor to every thread; ends after a barrier,
// so aux is free again. red_lh: THREADS/32 float2, red_i: THREADS/32 ints.
template <int THREADS>
__device__ float subsample_floor(const float* sub, int s, float* aux, const DetectParams& prm, float2* red_lh,
                                 int* red_i) {
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (int i = tid; i < s; i += THREADS) {
    const float db = sub_db(sub[i], prm);
    aux[i] = db;
    lo = fminf(lo, db);
    hi = fmaxf(hi, db);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) red_lh[warp] = make_float2(lo, hi);
  __syncthreads();
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    lo = fminf(lo, red_lh[w].x);
    hi = fmaxf(hi, red_lh[w].y);
  }
  int* hist = reinterpret_cast<int*>(aux + s);
  const float nf = floor_select<THREADS>(aux, s, lo, hi, prm, hist, reinterpret_cast<float*>(hist + FLOOR_NB), red_i);
  __syncthreads();  // every read of aux is done
  return nf;
}

// A block's detect columns d0 .. d0 + dn - 1 (dn a multiple of 4) in
// natural order: nat[rad + c*n2 + k2] = power of CT (k2, d0 + c), with
// nat[0 .. rad) the last rad bins of column d0 - 1 and nat[rad + dn*n2 ..
// + rad) the first rad bins of column d0 + dn (circular: n1 - 1 before
// 0, 0 after n1 - 1), rad <= n2. src.quad(k2, k1) reads the powers of CT
// (k2, k1 .. k1 + 3) (one 16-byte load), src.one(k2, k1) one power.
// Consecutive threads take consecutive k2. Ends after a barrier.
template <int THREADS, typename Src>
__device__ __forceinline__ void pull_natural(float* nat, int d0, int dn, int n1, int n2, int rad, const Src& src) {
  const int tid = static_cast<int>(threadIdx.x);
  const int bins = dn * n2;
  for (int u = tid; u < n2 * (dn / 4); u += THREADS) {
    const int q = u / n2, k2 = u - q * n2;
    const float4 f = src.quad(k2, d0 + 4 * q);
    float* d = nat + rad + 4 * q * n2 + k2;
    d[0] = f.x;
    d[n2] = f.y;
    d[2 * n2] = f.z;
    d[3 * n2] = f.w;
  }
  for (int h = tid; h < (dn > 0 ? 2 * rad : 0); h += THREADS) {
    const bool before = h < rad;
    const int k2 = before ? n2 - rad + h : h - rad;  // the left column's last / the right column's first bins
    const int k1 = before ? (d0 == 0 ? n1 - 1 : d0 - 1) : (d0 + dn == n1 ? 0 : d0 + dn);
    nat[before ? h : bins + h] = src.one(k2, k1);
  }
  __syncthreads();
}

// The detect over pull_natural's columns: 4 bins u .. u + 3 a lane (one
// column, 8 | n2), a segment two lanes, 128 bins a warp (the last warp's
// lanes past the block's bins compute on what follows nat and write
// nothing). Bin u + b's window is nat[u + b .. u + b + 2 rad], read as
// float4s: the positions q = 3 .. 2 rad all four share (core), q < 3
// (lo[b], b <= q) and q > 2 rad (hi[b], b >= q - 2 rad). The gates but
// the confidence gate, which waits for the floor: a segment's best score
// passes it or none of its scores does (monotone in the power). Stages
// each segment's (best, lowest in-segment argmax) at st_sc/st_sa[(k2/8)*dn
// + c]; nat + dn*n2 + 2*rad + 4 onwards may hold them. No barrier.
template <int THREADS>
__device__ __forceinline__ void window_partials(const float* nat, int d0, int dn, int n2, const DetectParams& prm,
                                                float* st_sc, float* st_sa) {
  constexpr int WARPS = THREADS / 32;
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int bins = dn * n2;
  const int rad = prm.radius;
  const int w2 = 2 * rad;
  const int nq = (w2 + 7) / 4;  // float4s covering q = 0 .. 2 rad + 3
  const int pure = (w2 - 3) / 4;  // chunks 1 .. pure hold core positions only
  for (int u0 = 128 * warp; u0 < bins; u0 += 128 * WARPS) {
    const int u = u0 + 4 * lane;
    const float4* win = reinterpret_cast<const float4*>(nat + u);
    float core = -CUDART_INF_F;
    float lo[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    float hi[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int ch = 1; ch <= pure; ++ch) {
      const float4 f = win[ch];
      core = fmaxf(core, fmaxf(fmaxf(f.x, f.y), fmaxf(f.z, f.w)));
    }
    for (int ch = 0; ch < nq; ch = (ch == 0 ? pure + 1 : ch + 1)) {
      const float4 f = win[ch];
      const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 4 * ch + e;
        if (q < 3) {
#pragma unroll
          for (int b = 0; b < 3; ++b) if (b <= q) lo[b] = fmaxf(lo[b], fv[e]);
        } else if (q <= w2) {
          core = fmaxf(core, fv[e]);
        } else {
#pragma unroll
          for (int b = 1; b < 4; ++b) if (q - w2 <= b) hi[b] = fmaxf(hi[b], fv[e]);
        }
      }
    }
    const int c = u / n2, k2 = u - c * n2;
    float sc[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float pv = nat[u + b + rad];
      const float mx = fmaxf(core, fmaxf(b < 3 ? lo[b] : -CUDART_INF_F, hi[b]));
      const float pe = __fadd_rn(pv, 1e-24f);
      const int k = k2 + b + n2 * (d0 + c);
      const bool cand = (pv >= mx) && (pe > prm.thr_lin) && (k >= prm.keep_lo) && (k <= prm.keep_hi);
      sc[b] = cand ? pv : -CUDART_INF_F;
    }
    float best = fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3]));
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, 1));
    int arg = SEG;
#pragma unroll
    for (int b = 3; b >= 0; --b) arg = sc[b] >= best ? 4 * (lane & 1) + b : arg;
    arg = min(arg, __shfl_xor_sync(0xffffffffu, arg, 1));
    if ((lane & 1) == 0 && u < bins) {
      st_sc[(k2 / SEG) * dn + c] = best;
      st_sa[(k2 / SEG) * dn + c] = static_cast<float>(arg);
    }
  }
}

// The confidence gate (floor nf) on the staged segments of window_partials
// and their stores: segment f = b2*n1 + d0 + c of the row whose first
// segment is seg0, for b2 < n2/8 = r.
template <int THREADS>
__device__ __forceinline__ void gate_partials(const float* st_sc, const float* st_sa, int d0, int dn, int n1, int r,
                                              size_t seg0, float nf, const DetectParams& prm,
                                              float* __restrict__ seg_score, float* __restrict__ seg_arg) {
  const float conf_lin = conf_level(nf, prm);
  for (int g = static_cast<int>(threadIdx.x); g < r * dn; g += THREADS) {
    const int b2 = g / dn, c = g - b2 * dn;
    const size_t f = seg0 + static_cast<size_t>(b2) * n1 + d0 + c;
    const float best = st_sc[g];
    const bool pass = !prm.has_conf || __fadd_rn(best, 1e-24f) >= conf_lin;
    seg_score[f] = pass ? best : -CUDART_INF_F;
    seg_arg[f] = pass ? st_sa[g] : 0.f;
  }
}

}  // namespace rm_det
