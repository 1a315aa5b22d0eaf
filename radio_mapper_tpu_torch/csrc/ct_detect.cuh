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
// confidence gate on each segment's best, and the stores); with
// emit_topk = K, in place of gate_partials: for K <= 8 topk_block8 (the
// block's own first K of its staged segments before the floor arrives: a
// threshold, the few segments at or above it ranked by one warp;
// topk_block where too many reach it) stored into the merger's inbox over
// DSMEM, and topk_merge8 (the merger gates and merges the c lists and
// writes the row's [128] block); above, topk_block (warp passes, a rank
// merge) and topk_merge (the merger pulls the lists over DSMEM).
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

// ---- the cluster designs' in-kernel top-K (emit_topk = k) ---------------
//
// block_topk's k passes each take the row's max m and the lowest segment
// f holding it; so its lanes are the segments of score > -inf in the
// order (score descending, f ascending), and once those run out every
// later pass takes f = 0: (-inf, 8*0 + seg_arg[0]). A cluster block's
// staged segment g = b2*dn + c is f = b2*n1 + d0 + c, increasing in g, so
// the block's own first k in (score, g) order are its first k in (score,
// f) order, and the row's first k are the first k of the c blocks' lists
// merged in (score, f) order. The confidence gate is monotone in the
// score (a segment passes iff its best + 1e-24 >= the floor's level), so
// the gated lists are prefixes of the ungated ones: each block lists its
// segments before the floor arrives, and the merger gates the lists.
//
// The top-K scratch T (floats) lies at the start of a block's freed column
// buffer, the same offset in every block, so the merger reads a partner's
// list through DSMEM: T[0, k) scores, T[k, 2k) segments f (int), T[2k,
// 3k) in-segment offsets (the block's list), T[3k] its length (int),
// T[3k + 1], T[3k + 2] segment 0's staged score and offset (on the block
// that holds column 0), T[3k + 3, topk_head(k)) the warps' list lengths,
// then the warps' lists (scores, then staged indices g; min(k,
// ceil(r*dn/WARPS)) entries a warp), which must end before st_sc; the
// merger stages the c lists there (topk_stage_floats).

constexpr int TOPK_PER_LANE = 8;  // a lane's staged segments in registers: r*dn <= THREADS*8
constexpr int TOPK_FAST = 8;      // k up to this: topk_block8 and topk_merge8

__host__ __device__ constexpr int topk_head(int k, int warps) { return 3 * k + 3 + warps; }

// Floats of T a block with r*dn staged segments uses before the merge: the
// warps' lists (k <= TOPK_FAST: room for topk_block8's gathered segments
// or topk_block's lists, 256 floats).
__host__ __device__ constexpr int topk_block_floats(int k, int warps, int staged) {
  const int chunk = (staged + warps - 1) / warps;
  return topk_head(k, warps) + 2 * warps * (k <= TOPK_FAST ? TOPK_FAST : (k < chunk ? k : chunk));
}

// Floats of T the merger uses for the c lists.
__host__ __device__ constexpr int topk_stage_floats(int k, int warps, int c) {
  return topk_head(k, warps) + 3 * c * k + c;
}

// A score as an unsigned key in the same order: 1 + its bits for a
// candidate (scores are powers, >= 0), 0 for none (-inf).
__device__ __forceinline__ unsigned topk_key(float v) { return v >= 0.f ? __float_as_uint(v) + 1u : 0u; }

// The entries of a list lv[0 .. n), sorted in the top-K order, before the
// entry (v, key): a larger score, or an equal one whose tie key lk[m]
// (none: the list's keys are all lower where lower_all) is lower. n <= 8:
// one unrolled pass of independent loads; else bisection.
__device__ __forceinline__ int topk_count_before(const float* lv, const int* lk, int n, float v, int key,
                                                 bool lower_all) {
  const auto before = [&](int m) {
    const float x = lv[m];
    return x > v || (x == v && (lk == nullptr ? lower_all : lk[m] < key));
  };
  if (n <= 8) {
    int cnt = 0;
#pragma unroll
    for (int m = 0; m < 8; ++m) cnt += (m < n && before(m)) ? 1 : 0;
    return cnt;
  }
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(mid)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Threads an entry when `lists` lists of `k` entries each merge by rank:
// the most (a power of 2, at most `lists`) that leave every entry a thread.
template <int THREADS>
__device__ __forceinline__ int topk_threads_an_entry(int lists, int k) {
  int tpe = 1;
  while (tpe < lists && lists * k * tpe * 2 <= THREADS) tpe *= 2;
  return tpe;
}

// ---- k <= TOPK_FAST: the merger's 64-bit keys in registers -------------
//
// A key is (1 + the score's bits) << 32 | ((0x0fffffff - f) << 3 |
// offset) (equal scores: the lower f first), 0 for no candidate; unsigned
// order is the top-K order. A list is 8 keys in descending order, and two
// lanes' lists merge into their first 8 by the bitonic rule: one list
// against the other reversed, the larger of each pair (a bitonic sequence
// holding the 8 largest), then a bitonic merge; branch-free, the same in
// every lane.

__device__ __forceinline__ unsigned long long topk_key64(float v, unsigned low) {
  return v >= 0.f ? (static_cast<unsigned long long>(__float_as_uint(v) + 1u) << 32) | low : 0ull;
}

__device__ __forceinline__ float topk_score64(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32) - 1u);
}

// Order x, y: the larger first.
__device__ __forceinline__ void topk_cas(unsigned long long& x, unsigned long long& y) {
  const unsigned long long hi = x > y ? x : y, lo = x > y ? y : x;
  x = hi;
  y = lo;
}

// The bitonic merge of a bitonic a[0 .. 8) into descending order.
__device__ __forceinline__ void topk_bitonic8(unsigned long long (&a)[8]) {
#pragma unroll
  for (int stride = 4; stride > 0; stride >>= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if ((i & stride) == 0) topk_cas(a[i], a[i + stride]);
}

// This lane's descending list and lane ^ o's into their first 8, in every
// lane of the pair.
__device__ __forceinline__ void topk_merge_lanes(unsigned long long (&a)[8], int o) {
  unsigned long long b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = __shfl_xor_sync(0xffffffffu, a[7 - i], o);
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = a[i] > b[i] ? a[i] : b[i];
  topk_bitonic8(a);
}

// The merger's inbox for k <= TOPK_FAST: the last TOPK_INBOX floats of its
// freed column buffer (past everything the detect half uses there), a
// slot of 32 a block: the list's length (int), 8 scores, 8 f (int), 8
// offsets. Every block stores its list into its slot through DSMEM before
// the floor's barrier; after it the merger reads them locally.
constexpr int TOPK_INBOX = 8 * 32;

template <int THREADS>
__device__ void topk_block(const float* st_sc, const float* st_sa, int r, int dn, int d0, int n1, int k, float* T);

// topk_block for k <= TOPK_FAST, its list stored into the merger's inbox
// slot `rank` (cl.st(p, b, v): the float v to this block's shared address
// p in block b, DSMEM). The segment g = tid + THREADS*i (i < 8) is a key in
// thread tid's registers. A threshold first: the k-th largest of the
// warps' largest keys is at most the block's k-th largest, so the block's
// first k are among the keys at or above it; those (typically a dozen) are
// gathered, and warp 0 ranks them (lane l: the gathered keys before its
// own, larger or equal at a lower g) and stores rank < k. Where more than
// 32 reach the threshold (many equal scores), topk_block lists them and
// warp 0 stores its list. Either way the outputs of topk_block. Every
// thread calls it after a barrier that follows the last write of st_sc
// and st_sa.
template <int THREADS, typename Cluster>
__device__ void topk_block8(const float* st_sc, const float* st_sa, int r, int dn, int d0, int n1, int k, float* T,
                            float* inbox, int rank, int merger, const Cluster& cl) {
  constexpr int WARPS = THREADS / 32;
  constexpr int GATHER = 32;
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int staged = r * dn;
  // scratch after topk_head: [0, WARPS) the warps' largest keys, [WARPS] the
  // threshold, [WARPS + 1] the gathered count, then GATHER keys and GATHER
  // indices
  unsigned* sc = reinterpret_cast<unsigned*>(T + topk_head(k, WARPS));
  unsigned* gk = sc + WARPS + 2;
  unsigned* gg = gk + GATHER;
  float* box = inbox + 32 * rank;
  if (threadIdx.x == 0) {
    if (staged > 0) {
      T[3 * k + 1] = st_sc[0];
      T[3 * k + 2] = st_sa[0];
    }
    sc[WARPS + 1] = 0u;
  }
  unsigned key[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int g = static_cast<int>(threadIdx.x) + THREADS * i;
    key[i] = g < staged ? topk_key(st_sc[g]) : 0u;
  }
  unsigned t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = key[i];
#pragma unroll
  for (int h = 4; h > 0; h >>= 1)
#pragma unroll
    for (int i = 0; i < h; ++i) t[i] = max(t[i], t[i + h]);
  const unsigned wm = __reduce_max_sync(0xffffffffu, t[0]);
  if (lane == 0) sc[warp] = wm;
  __syncthreads();
  if (warp == 0) {  // the k-th largest of the warps' largest keys: the least of those with fewer than k above
    const unsigned w = lane < WARPS ? sc[lane] : 0u;
    int above = 0;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) above += sc[j] > w ? 1 : 0;
    const unsigned tau = __reduce_min_sync(0xffffffffu, lane < WARPS && above < k ? w : 0xffffffffu);
    if (lane == 0) sc[WARPS] = tau;
  }
  __syncthreads();
  const unsigned tau = sc[WARPS];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool keep = key[i] != 0u && key[i] >= tau;
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (mask != 0u) {
      unsigned base = 0u;
      if (lane == 0) base = atomicAdd(&sc[WARPS + 1], static_cast<unsigned>(__popc(mask)));
      base = __shfl_sync(0xffffffffu, base, 0);
      const unsigned pos = base + static_cast<unsigned>(__popc(mask & ((1u << lane) - 1u)));
      if (keep && pos < GATHER) {
        gk[pos] = key[i];
        gg[pos] = static_cast<unsigned>(threadIdx.x) + THREADS * i;
      }
    }
  }
  __syncthreads();
  const int total = static_cast<int>(sc[WARPS + 1]);
  if (total <= GATHER) {
    if (warp == 0) {
      const unsigned kl = lane < total ? gk[lane] : 0u;
      const int gl = lane < total ? static_cast<int>(gg[lane]) : 0x7fffffff;
      int before = 0;
#pragma unroll
      for (int j = 0; j < GATHER; ++j) {
        const unsigned kj = __shfl_sync(0xffffffffu, kl, j);
        const int gj = __shfl_sync(0xffffffffu, gl, j);
        before += (kj > kl || (kj == kl && gj < gl)) ? 1 : 0;
      }
      if (lane < total && before < k) {  // entry `before` of the list: staged index gl
        const int b2 = gl / dn, c = gl - b2 * dn;
        cl.st(box + 1 + before, merger, __uint_as_float(kl - 1u));
        cl.st(box + 9 + before, merger, __int_as_float(b2 * n1 + d0 + c));
        cl.st(box + 17 + before, merger, st_sa[gl]);
      }
      if (lane == 0) cl.st(box, merger, __int_as_float(min(k, total)));
    }
    return;
  }
  __syncthreads();  // every read of the gathered count is done: topk_block reuses the scratch
  topk_block<THREADS>(st_sc, st_sa, r, dn, d0, n1, k, T);
  __syncthreads();  // the list is in T
  if (warp == 0) {
    const int n = reinterpret_cast<const int*>(T)[3 * k];
    if (lane < n) {
      cl.st(box + 1 + lane, merger, T[lane]);
      cl.st(box + 9 + lane, merger, T[k + lane]);
      cl.st(box + 17 + lane, merger, T[2 * k + lane]);
    }
    if (lane == 0) cl.st(box, merger, __int_as_float(n));
  }
}

// The merger's half for k <= TOPK_FAST (the block that holds column 0,
// after the floor's cluster barrier, which follows every block's store
// into its inbox): the row's [128] block from the c lists, as topk_merge
// gives it. Warp 0's lane b < c loads slot b as keys with the low word
// ((0x0fffffff - f) << 3 | offset), three butterfly merges give lane 0 the
// first 8 in (score, f) order, and lane j < k writes lane j: the entry if
// it passes the confidence gate (a list's passing entries come first),
// else (-inf, segment 0's gated offset); lanes k .. 127 get 0. It reads
// only this block's shared memory.
template <int THREADS>
__device__ void topk_merge8(const float* inbox, const float* T, int c, int k, float nf, const DetectParams& prm,
                            float* __restrict__ vals, float* __restrict__ packed) {
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  if (warp == 0) {
    unsigned long long a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = 0ull;
    if (lane < c) {
      const float* box = inbox + 32 * lane;
      const int n = __float_as_int(box[0]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < n) {
          const unsigned f = static_cast<unsigned>(__float_as_int(box[9 + i]));
          a[i] = topk_key64(box[1 + i], ((0x0fffffffu - f) << 3) | static_cast<unsigned>(box[17 + i]));
        }
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) topk_merge_lanes(a, o);  // c <= 8 lists, lanes 0 .. 7
    unsigned long long e = 0ull;
#pragma unroll
    for (int i = 0; i < 8; ++i) e = i == lane ? a[i] : e;
    if (lane < k) {
      const float conf_lin = conf_level(nf, prm);
      const auto pass = [&](float v) { return !prm.has_conf || __fadd_rn(v, 1e-24f) >= conf_lin; };
      const float v = topk_score64(e);
      const bool ok = e != 0ull && pass(v);
      const unsigned low = static_cast<unsigned>(e);
      const float f = static_cast<float>(0x0fffffffu - (low >> 3));
      vals[lane] = ok ? v : -CUDART_INF_F;
      packed[lane] = ok ? __fadd_rn(__fmul_rn(8.f, f), static_cast<float>(low & 7u))
                        : (pass(T[3 * k + 1]) ? T[3 * k + 2] : 0.f);
    }
  }
  for (int j = k + static_cast<int>(threadIdx.x); j < TOPK_LANES; j += THREADS) {
    vals[j] = 0.f;
    packed[j] = 0.f;
  }
}

// A block's first k staged segments in (score, f) order, ungated (the
// merger gates): warp w takes the staged indices [w*chunk, (w + 1)*chunk),
// lane l the stride g = w*chunk + l + 32*i, i < TOPK_PER_LANE, as keys in
// registers; each of up to k passes takes the warp's largest key
// (__reduce_max_sync) and the lowest g holding it (__reduce_min_sync),
// ending where none is left, and its lane clears it. The warps' lists then
// merge by rank: an entry's rank is its place in its list plus, for each
// other warp, the entries before it there (a larger score, or an equal
// one in a warp of lower g); entries of rank < k go to T[rank] with f =
// b2*n1 + d0 + c and the staged offset, T[3k] holds the list's length,
// min(k, the block's candidates), and T[3k + 1], T[3k + 2] segment 0's
// staged score and offset (meaningful where d0 = 0). Every thread calls it
// after a barrier that follows the last write of st_sc and st_sa; it ends
// without a barrier after its last write of T. For k > TOPK_FAST
// (topk_block8 below that).
template <int THREADS>
__device__ void topk_block(const float* st_sc, const float* st_sa, int r, int dn, int d0, int n1, int k, float* T) {
  constexpr int WARPS = THREADS / 32;
  const int lane = static_cast<int>(threadIdx.x) & 31, warp = static_cast<int>(threadIdx.x) >> 5;
  const int staged = r * dn;
  const int chunk = (staged + WARPS - 1) / WARPS;
  const int kw = min(k, chunk);
  int* tf = reinterpret_cast<int*>(T + k);
  int* wcnt = reinterpret_cast<int*>(T + 3 * k + 3);
  float* wv = T + topk_head(k, WARPS);
  int* wg = reinterpret_cast<int*>(wv + WARPS * kw);
  if (threadIdx.x == 0 && staged > 0) {
    T[3 * k + 1] = st_sc[0];
    T[3 * k + 2] = st_sa[0];
  }
  const int gb = warp * chunk, ge = min(staged, gb + chunk);
  unsigned key[TOPK_PER_LANE];
#pragma unroll
  for (int i = 0; i < TOPK_PER_LANE; ++i) {
    const int g = gb + lane + 32 * i;
    key[i] = g < ge ? topk_key(st_sc[g]) : 0u;
  }
  int cnt = 0;
  for (int j = 0; j < kw; ++j) {
    unsigned t[TOPK_PER_LANE];  // the lane's best key, then the lowest g holding m: pairwise trees
#pragma unroll
    for (int i = 0; i < TOPK_PER_LANE; ++i) t[i] = key[i];
#pragma unroll
    for (int h = TOPK_PER_LANE / 2; h > 0; h >>= 1)
#pragma unroll
      for (int i = 0; i < h; ++i) t[i] = max(t[i], t[i + h]);
    const unsigned m = __reduce_max_sync(0xffffffffu, t[0]);
    if (m == 0u) break;  // the warp's candidates are spent (the same m in every lane)
#pragma unroll
    for (int i = 0; i < TOPK_PER_LANE; ++i) {
      t[i] = key[i] == m ? static_cast<unsigned>(gb + lane + 32 * i) : 0xffffffffu;
    }
#pragma unroll
    for (int h = TOPK_PER_LANE / 2; h > 0; h >>= 1)
#pragma unroll
      for (int i = 0; i < h; ++i) t[i] = min(t[i], t[i + h]);
    const int mg = static_cast<int>(__reduce_min_sync(0xffffffffu, t[0]));
#pragma unroll
    for (int i = 0; i < TOPK_PER_LANE; ++i) key[i] = gb + lane + 32 * i == mg ? 0u : key[i];
    if (lane == 0) {
      wv[warp * kw + j] = __uint_as_float(m - 1u);
      wg[warp * kw + j] = mg;
    }
    cnt = j + 1;
  }
  if (lane == 0) wcnt[warp] = cnt;
  __syncthreads();  // every warp's list is complete
  int total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += wcnt[w];
  // the rank merge, tpe threads an entry: each counts the entries before it
  // in every tpe-th other list, the counts summed over the tpe lanes
  const int slots = WARPS * kw, tpe = topk_threads_an_entry<THREADS>(WARPS, kw);
  for (int base = 0; base < slots * tpe; base += THREADS) {
    const int t = base + static_cast<int>(threadIdx.x), e = t / tpe, p = t - e * tpe;
    const int w = e < slots ? e / kw : 0, i = e - w * kw;
    const bool live = e < slots && i < wcnt[w];
    int before = 0;
    if (live) {
      const float v = wv[e];
      for (int u = p; u < WARPS; u += tpe) {  // warp u's g lie below this g where u < w
        if (u != w) before += topk_count_before(wv + u * kw, nullptr, wcnt[u], v, 0, u < w);
      }
    }
    for (int o = 1; o < tpe; o <<= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
    if (live && p == 0 && i + before < k) {
      const int rank = i + before, g = wg[e], b2 = g / dn, c = g - b2 * dn;
      T[rank] = wv[e];
      tf[rank] = b2 * n1 + d0 + c;
      T[2 * k + rank] = st_sa[g];
    }
  }
  if (threadIdx.x == 0) reinterpret_cast<int*>(T)[3 * k] = min(k, total);
}

// topk_merge's staging for k > TOPK_FAST: the c lists and their lengths
// from the blocks' T into this block's T after topk_head, then a barrier.
// remote(p, b) reads the float at this block's address p in block b
// (DSMEM).
template <int THREADS, typename Remote>
__device__ void topk_stage(float* T, int c, int k, const Remote& remote) {
  constexpr int WARPS = THREADS / 32;
  float* sv = T + topk_head(k, WARPS);
  for (int e = static_cast<int>(threadIdx.x); e < c * k; e += THREADS) {
    const int b = e / k, i = e - b * k;
#pragma unroll
    for (int p = 0; p < 3; ++p) sv[p * c * k + e] = remote(T + p * k + i, b);
  }
  if (static_cast<int>(threadIdx.x) < c) {
    const int b = static_cast<int>(threadIdx.x);
    sv[3 * c * k + b] = remote(T + 3 * k, b);
  }
  __syncthreads();
}

// topk_merge's write for k > TOPK_FAST: the row's [128] block from the
// staged lists, gated by the floor nf as
// gate_partials gates (the passing entries of a list are its first ones):
// a passing entry's rank is its place in its list plus, for each other
// list, its entries before it in (score, f) order (all passing); lane rank < k gets
// (score, 8*f + offset), exact in float32; lanes from the passing total
// to k get (-inf, segment 0's gated offset), segment 0 being this block's
// staged index 0 (T[3k + 1], T[3k + 2]); lanes k .. 127 get 0.
template <int THREADS>
__device__ void topk_write(const float* T, int c, int k, float nf, const DetectParams& prm, float* __restrict__ vals,
                           float* __restrict__ packed) {
  constexpr int WARPS = THREADS / 32;
  const float* sv = T + topk_head(k, WARPS);
  const int* sf = reinterpret_cast<const int*>(sv + c * k);
  const float* sa = sv + 2 * c * k;
  const int* cnts = reinterpret_cast<const int*>(sv + 3 * c * k);
  const float conf_lin = conf_level(nf, prm);
  const auto pass = [&](float v) { return !prm.has_conf || __fadd_rn(v, 1e-24f) >= conf_lin; };
  const int slots = c * k;
  int total = 0;  // the passing entries (a list's passing entries are its first)
  for (int base = 0; base < slots; base += THREADS) {
    const int e = base + static_cast<int>(threadIdx.x), b = e / k;
    total += __syncthreads_count(e < slots && e - b * k < cnts[b] && pass(sv[e]));
  }
  // the rank merge, tpe threads an entry: each counts the entries before it
  // in every tpe-th other list (an entry before a passing one passes), the
  // counts summed over the tpe lanes
  const int tpe = topk_threads_an_entry<THREADS>(c, k);
  for (int base = 0; base < slots * tpe; base += THREADS) {
    const int t = base + static_cast<int>(threadIdx.x), e = t / tpe, p = t - e * tpe;
    const int b = e < slots ? e / k : 0, i = e - b * k;
    const bool live = e < slots && i < cnts[b] && pass(sv[e]);
    int before = 0;
    if (live) {
      for (int u = p; u < c; u += tpe) {
        if (u != b) before += topk_count_before(sv + u * k, sf + u * k, cnts[u], sv[e], sf[e], false);
      }
    }
    for (int o = 1; o < tpe; o <<= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
    if (live && p == 0 && i + before < k) {
      vals[i + before] = sv[e];
      packed[i + before] = __fadd_rn(__fmul_rn(8.f, static_cast<float>(sf[e])), sa[e]);
    }
  }
  const float arg0 = pass(T[3 * k + 1]) ? T[3 * k + 2] : 0.f;
  const int have = min(k, total);
  for (int j = have + static_cast<int>(threadIdx.x); j < TOPK_LANES; j += THREADS) {
    vals[j] = j < k ? -CUDART_INF_F : 0.f;
    packed[j] = j < k ? arg0 : 0.f;
  }
}

// The merger's half for k > TOPK_FAST (the block that holds column 0,
// after the cluster barrier that follows every block's topk_block): the
// row's [128] block from the c lists, gated by the floor nf as
// gate_partials gates (a list's passing entries are its first; an entry
// before a passing one passes): lane j < k the j-th passing entry in
// (score, f) order, (score, 8*f + offset), exact in float32; lanes from the
// passing total to k (-inf, segment 0's gated offset, segment 0 being this
// block's staged index 0: T[3k + 1], T[3k + 2]); lanes k .. 127 0.
// topk_stage with cl.ld(p, b) (the float at this block's address p in
// block b, DSMEM), then cl.arrive() (this thread's arrival at the last
// cluster barrier: no partner's list is read again), then topk_write.
template <int THREADS, typename Cluster>
__device__ void topk_merge(float* T, int c, int k, float nf, const DetectParams& prm, float* __restrict__ vals,
                           float* __restrict__ packed, const Cluster& cl) {
  topk_stage<THREADS>(T, c, k, [&](const float* p, int b) { return cl.ld(p, b); });
  cl.arrive();
  topk_write<THREADS>(T, c, k, nf, prm, vals, packed);
}

}  // namespace rm_det
