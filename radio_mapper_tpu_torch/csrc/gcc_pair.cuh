// Shared device code: one GCC pair's lag window -- cross-power R = X conj(Y),
// whitening, four-step inverse transform of the lag-window rows only, |r|/n.
//
// The body of kernels K2, K5 and K6 (gcc_pair.cu) at the inner lengths
// n1 = 128 and 256, and of the pair stage of kernel K8 (channel_step.cu);
// it is radio_mapper_tpu/ops/pallas/gcc_kernel.py::_whiten +
// _invert_to_lag_windows for one pair. The wide lengths n1 = 384, 640 and
// 896 run gcc_pair_wide.cuh's body (one kernel a length, bulk copies, the
// fold on tensor cores), which reuses the whitening below.
//
// Input spectra are in CT order (bin k = k2 + n2*k1 at m = k2*n1 + k1); the
// inverse consumes that order and emits time t = q*n1 + p:
//   R[k2][k1] = whiten(X * conj(Y))
//   E[k2][p]  = sum_k1 R[k2][k1] W_n1^(-k1 p)    (inner inverse n1-point FFT)
//   C[k2][p]  = E[k2][p] * TWc[k2][p]
//   z[q][p]   = sum_k2 W2c[q][k2] C[k2][p]       (outer, window rows q only)
//
// Inner transform, n1 = 32*P with P = 4 or 8: one warp per CT row k2.
// Lane l loads bins k1 = l + 32*i (i < P) of X and Y (each load of the warp
// one coalesced 128-byte line), forms the whitened R in registers and runs
// a DIF FFT with conjugate twiddles W_n1^-e (e < n1/2,
// ct_plan.inverse_radix_table): first the radix-2 stages of half-size
// h = n1/2 .. 32 in registers (points i and i + h/32), then the stages
// h = 16 .. 1, which pair lane l with lane l ^ h through __shfl_xor_sync.
// In this layout every twiddle exponent depends on the lane (and i) but not
// on the row, so each lane loads its P - 1 + 5 twiddles once a block. Point
// i of lane l then holds E[brev(l + 32*i)] = E[P*brev5(l) + brev(i)]: P
// consecutive times, multiplied by the inverse twiddle and stored to the
// chunk buffer with 16-byte stores, at swizzled places (swz) that keep the
// stores and the fold's reads free of bank conflicts.
// tests/test_torch_pair_fft.py replays this schedule in numpy and counts
// the banks of those stores and reads.
//
// Outer transform: the rows k2 are processed in chunks of 256/n1 rows a
// warp; each chunk's C is folded straight into the window accumulators on
// the CUDA cores, in k2 order whatever the chunk size, so a block of any
// THREADS gives the same sums (kernel K8, 512 threads, equals K2, 256
// threads, bit for bit).
//
// Whitening (gcc_kernel._whiten, the gate of set_phat_gate):
//   l2rx  R * rsqrt(|R|^2 + eps^2 * s2 + 1e-30), s2 given per pair
//         (max|X_i|^2 * max|Y_j|^2 from the per-receiver maxima)
//   l2    the same with s2 = max_k |R|^2 of this pair
//   l1    R / (mag + eps * max_k mag + 1e-30), mag = |R|^2 * rsqrt(|R|^2 + 1e-30)
//   none  R unchanged ("cc", no whitening)
// l2 and l1 need the pair's maximum before any bin is whitened: a first
// pass over the n bins forms R and block-reduces it, so those two gates
// read X and Y twice (mostly from L2).

#pragma once

#include <cuda_runtime.h>

#include "ct_dft.cuh"
#include "ct_fft.cuh"

namespace rm_pair {

constexpr int RJ = 8;  // chunk rows = (THREADS / n1) * RJ = 256 / n1 rows a warp (n1 <= 256)

// Chunk rows of a block of THREADS at inner length n1 = 128, 256: 256/n1
// rows a warp.
__host__ __device__ constexpr int chunk_rows(int threads, int n1) { return (threads / n1) * RJ; }

enum Gate : int { GATE_L2RX = 0, GATE_L2 = 1, GATE_L1 = 2, GATE_NONE = 3 };

// Spectra loads: read-only-cache loads where the spectra predate the
// launch; L2 loads (no L1) where another block of the same launch wrote
// them (kernel K8).
template <bool FRESH>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (FRESH) return __ldcg(p);
  else return __ldg(p);
}

__device__ __forceinline__ void cross(float ar, float ai, float br, float bim, float& rr, float& ri) {
  rr = __fadd_rn(__fmul_rn(ar, br), __fmul_rn(ai, bim));
  ri = __fsub_rn(__fmul_rn(ai, br), __fmul_rn(ar, bim));
}

// The gate on one cross-power bin (floor2: eps^2 * s2 for l2rx and l2;
// l1_floor: eps * max mag for l1).
__device__ __forceinline__ float2 whiten(float rr, float ri, int gate, float floor2, float l1_floor) {
  if (gate == GATE_NONE) return make_float2(rr, ri);
  const float p2 = __fadd_rn(__fmul_rn(rr, rr), __fmul_rn(ri, ri));
  float inv;
  if (gate == GATE_L1) {
    const float mag = __fmul_rn(p2, rsqrtf(__fadd_rn(p2, 1e-30f)));
    inv = __fdiv_rn(1.f, __fadd_rn(__fadd_rn(mag, l1_floor), 1e-30f));
  } else {
    inv = rsqrtf(__fadd_rn(__fadd_rn(p2, floor2), 1e-30f));
  }
  return make_float2(__fmul_rn(rr, inv), __fmul_rn(ri, inv));
}

// A lane's twiddles for the warp FFT of N1 = 32*P points, P = 4 or 8:
// reg[P - h/16 + j] for the register stage h (h = N1/2 .. 32, j < h/32) is
// W^-((l + 32j)*N1/(2h)); lane[s] for the shuffle stage h = 16 >> s is
// W^-((l mod h)*N1/(2h)) where lane bit h is set and 1 where it is clear
// (that lane keeps the sum).
template <int N1>
struct RowTwiddles {
  float2 reg[N1 / 32 - 1];
  float2 lane[5];
};

template <int N1>
__device__ __forceinline__ RowTwiddles<N1> row_twiddles(const float2* __restrict__ wi, int lane) {
  constexpr int P = N1 / 32;
  static_assert(rm_fft::is_pow2(P), "the narrow pair body takes n1 = 128, 256");
  RowTwiddles<N1> t;
#pragma unroll
  for (int h = N1 / 2; h >= 32; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h / 32; ++j) t.reg[P - h / 16 + j] = __ldg(wi + (lane + 32 * j) * (N1 / 2 / h));
  }
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int h = 16 >> s;
    t.lane[s] = (lane & h) ? __ldg(wi + (lane & (h - 1)) * (N1 / 2 / h)) : make_float2(1.f, 0.f);
  }
  return t;
}

// The inverse N1-point FFT of one row held by a warp, point i of lane l at
// k1 = l + 32*i (see the header).
template <int N1>
__device__ __forceinline__ void inverse_row_fft(float2 (&v)[N1 / 32], const RowTwiddles<N1>& tw,
                                                int lane) {
  constexpr int P = N1 / 32;
#pragma unroll
  for (int h = N1 / 2; h >= 32; h >>= 1) {
    const int g = h / 32;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i & g) continue;
      const float2 a = v[i], b = v[i + g];
      v[i] = rm_fft::cadd(a, b);
      v[i + g] = rm_ct::cmul(rm_fft::csub(a, b), tw.reg[P - h / 16 + (i & (g - 1))]);
    }
  }
  // lane bit h clear: v + w (times 1); set: (w - v) * W, with no select
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int h = 16 >> s;
    const float sg = (lane & h) ? -1.f : 1.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float2 w = make_float2(__shfl_xor_sync(0xffffffffu, v[i].x, h),
                                   __shfl_xor_sync(0xffffffffu, v[i].y, h));
      v[i] = rm_ct::cmul(make_float2(fmaf(sg, v[i].x, w.x), fmaf(sg, v[i].y, w.y)), tw.lane[s]);
    }
  }
}

// Where time p of a row sits in the chunk buffer: bits 1..3 of p XOR the
// three bits above log2(4P). A lane stores P consecutive times from
// p0 = P*brev5(lane), so the 8 lanes of a quarter-warp differ only in those
// three bits: swizzled, their 16-byte stores hit 8 different bank groups
// (unswizzled, all 8 hit the same 4 banks). Bit 0 stays, so a pair of times
// stays one 16-byte word, and 16 consecutive times stay a permutation of
// themselves, so the fold's reads of consecutive p stay conflict-free.
template <int P>
__device__ __forceinline__ int swz(int p) {
  return p ^ (((p / (4 * P)) & 7) << 1);
}

// A lane's P times p0 + q (q = Q, Q + 1, ...) from its points i = digit_inv(q),
// times the inverse twiddle, two per 16-byte load and store (the point
// indices are constants, so v stays in registers); row: the chunk buffer's
// row, 16-byte aligned.
template <int P, int Q>
__device__ __forceinline__ void twiddle_store(const float2 (&v)[P], const float4* __restrict__ tq,
                                              float2* row, int p0) {
  if constexpr (Q < P) {
    constexpr int i0 = rm_fft::digit_inv<P>(Q);
    constexpr int i1 = rm_fft::digit_inv<P>(Q + 1);
    const float4 t = __ldg(tq + Q / 2);
    const float2 c0 = rm_ct::cmul(v[i0], make_float2(t.x, t.y));
    const float2 c1 = rm_ct::cmul(v[i1], make_float2(t.z, t.w));
    *reinterpret_cast<float4*>(row + swz<P>(p0 + Q)) = make_float4(c0.x, c0.y, c1.x, c1.y);
    twiddle_store<P, Q + 2>(v, tq, row, p0);
  }
}

// The chunk loop of pair_lag_window for n1 = N1: each warp whitens and
// transforms its rows of the chunk into rbuf [chunk][N1] (16-byte aligned),
// then the block folds the chunk into the window accumulators
// z [nneg + npos][N1].
template <int N1, int THREADS, bool FRESH>
__device__ __forceinline__ void pair_chunks(
    const float* xr, const float* xi, const float* yr, const float* yi,
    int gate, float floor2, float l1_floor,
    const float2* __restrict__ wi, const float2* __restrict__ w2,
    const float2* __restrict__ tw, float2* rbuf, float2* z, int n2, int nneg, int npos) {
  constexpr int P = N1 / 32;
  constexpr int WARPS = THREADS / 32;
  constexpr int ROWS = chunk_rows(THREADS, N1) / WARPS;  // chunk rows a warp
  constexpr int chunk = WARPS * ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = nneg + npos;
  const int p0 = P * static_cast<int>(__brev(lane) >> 27);  // this lane's first time p
  const RowTwiddles<N1> rtw = row_twiddles<N1>(wi, lane);
  for (int r0 = 0; r0 < n2; r0 += chunk) {
    const int rows = min(chunk, n2 - r0);

    // Every branch around the loads and shuffles is the same for the whole
    // block, so the shuffles need no warp-sync fallback: a warp past the
    // chunk's last row (only where rows is not a multiple of WARPS)
    // transforms the chunk's first row again and stores nothing.
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (WARPS * j >= rows) break;
      const int rl = warp + WARPS * j;
      const bool live = rl < rows;
      const int k2 = r0 + (live ? rl : 0);
      const int off = k2 * N1 + lane;
      const float *ar = xr + off, *ai = xi + off, *br = yr + off, *bi = yi + off;
      float2 v[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        float rr, ri;
        cross(load<FRESH>(ar + 32 * i), load<FRESH>(ai + 32 * i), load<FRESH>(br + 32 * i),
              load<FRESH>(bi + 32 * i), rr, ri);
        v[i] = whiten(rr, ri, gate, floor2, l1_floor);
      }
      inverse_row_fft<N1>(v, rtw, lane);
      if (live) {
        twiddle_store<P, 0>(v, reinterpret_cast<const float4*>(tw + k2 * N1 + p0), rbuf + rl * N1, p0);
      }
    }
    __syncthreads();

    // outer inverse DFT over this chunk's k2, window rows only: neg rows
    // q = n2 - nneg .. n2 - 1 first, then pos rows q = 0 .. npos - 1
    for (int o = tid; o < nw * N1; o += THREADS) {
      const int qw = o / N1, pp = o - qw * N1;
      const int q = (qw < nneg) ? (n2 - nneg + qw) : (qw - nneg);
      const float2* wq = w2 + q * n2 + r0;
      const float2* cp = rbuf + swz<P>(pp);
      float2 a = z[o];
      for (int rl = 0; rl < rows; ++rl) rm_ct::cmac(a, __ldg(wq + rl), cp[rl * N1]);
      z[o] = a;
    }
    __syncthreads();  // rbuf is overwritten by the next chunk
  }
}

// One pair: X = (xr, xi), Y = (yr, yi) CT-order rows of n = n1*n2 (n1 = 128
// or 256; gcc_pair_wide.cuh takes 384, 640 and 896), gate mode `gate` (l2rx floor
// eps2 * s2 in floor2; eps2 = eps^2 and eps for the per-pair gates), window
// |r|/n written to orow[0 .. 2*max_lag]. wi: W_n1^-e, e < n1/2; tw: the
// inverse twiddle [n2][n1], 16-byte aligned. sm: (chunk_rows(THREADS, n1)
// + nneg + npos) * n1 float2 of shared memory, 16-byte aligned.
template <int THREADS, bool FRESH>
__device__ void pair_lag_window(
    const float* xr, const float* xi, const float* yr, const float* yi,
    int gate, float floor2, float eps2, float eps,
    const float2* __restrict__ wi, const float2* __restrict__ w2,
    const float2* __restrict__ tw, float* __restrict__ orow, float2* sm,
    int n1, int n2, int nneg, int npos, int max_lag, float inv_n) {
  __shared__ float red[THREADS / 32];
  const int chunk = chunk_rows(THREADS, n1);
  const int nw = nneg + npos;
  float2* rbuf = sm;              // [chunk][n1] C of the chunk's rows
  float2* z = sm + chunk * n1;    // [nw][n1] window accumulators
  const int tid = threadIdx.x;

  for (int o = tid; o < nw * n1; o += THREADS) z[o] = make_float2(0.f, 0.f);

  // l2 / l1: the pair's max |R|^2 (or max mag) first
  float scale = 0.f;
  if (gate == GATE_L2 || gate == GATE_L1) {
    const int n = n1 * n2;
    float v = 0.f;  // |R|^2 and mag are >= 0
    for (int m = tid; m < n; m += THREADS) {
      float rr, ri;
      cross(load<FRESH>(xr + m), load<FRESH>(xi + m), load<FRESH>(yr + m), load<FRESH>(yi + m), rr, ri);
      const float p2 = __fadd_rn(__fmul_rn(rr, rr), __fmul_rn(ri, ri));
      v = fmaxf(v, gate == GATE_L2 ? p2 : __fmul_rn(p2, rsqrtf(__fadd_rn(p2, 1e-30f))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((tid & 31) == 0) red[tid >> 5] = v;
    __syncthreads();
    scale = red[0];
    for (int w = 1; w < THREADS / 32; ++w) scale = fmaxf(scale, red[w]);
    if (gate == GATE_L2) floor2 = __fmul_rn(eps2, scale);
  }
  const float l1_floor = __fmul_rn(eps, scale);

  if (n1 == 256) {
    pair_chunks<256, THREADS, FRESH>(xr, xi, yr, yi, gate, floor2, l1_floor, wi, w2, tw, rbuf, z, n2,
                                     nneg, npos);
  } else {
    pair_chunks<128, THREADS, FRESH>(xr, xi, yr, yi, gate, floor2, l1_floor, wi, w2, tw, rbuf, z, n2,
                                     nneg, npos);
  }

  // lags -L..-1 are the last L samples of the neg rows, 0..L the first
  // L+1 of the pos rows: one contiguous run of z
  const int width = 2 * max_lag + 1;
  const float2* zw = z + nneg * n1 - max_lag;
  for (int t = tid; t < width; t += THREADS) {
    const float2 v = zw[t];
    orow[t] = __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y))), inv_n);
  }
}

// The inner lengths pair_lag_window takes (gcc_pair_wide.cuh: the rest).
inline bool pair_n1_supported(int n1) { return n1 == 128 || n1 == 256; }

// Shared memory of pair_lag_window for a block of THREADS.
template <int THREADS>
size_t pair_smem_bytes(int n1, int nneg, int npos) {
  const int chunk = chunk_rows(THREADS, n1);
  return static_cast<size_t>(chunk + nneg + npos) * n1 * sizeof(float2);
}

}  // namespace rm_pair
