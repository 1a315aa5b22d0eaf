// Kernels K9 and K10: the narrowband pair stage (the coherent all-pairs
// GCC-PHAT of a multi-dwell capture) at the reference's 5-smooth nfft N =
// N1 * N2 (135000 = 1080 * 125; the complex step's 17280 = 1080 * 16), on
// the mixed-radix core of mixed_fft.cuh.
//
// Replace no TPU kernel: the JAX package runs this stage as XLA dots (its
// matmul four-step, radio_mapper_tpu/ops/fft.py _fft_re_im, forward and
// inverse over every bin of every pair). The port ran the same dots as FP32
// GEMMs of DFT matrices, 69 times the work of a radix FFT at 135000 and the
// whole inverse of which it kept 2L+1 lags. Python wrapper, plan, tables and
// plain PyTorch versions: radio_mapper_tpu_torch/ops/cuda/pair_fft.py.
// tests/test_torch_mixed_fft.py replays these schedules in numpy.
//
// K9, the receiver FFT, one C entry of two kernels, in place on its output:
//   columns: for each row and each t1 < N1, the N2-point DFT over t2 of
//     x[t1 + N1*t2] (zero past the capture's length: the zero-padding is in
//     the loads), times W_N^{t1*k2}, stored at [row][k2][t1]. A block takes
//     40 consecutive t1 of a row, so its loads are runs of 40 samples.
//   rows: for each row and k2, the N1-point DFT of [row][k2][.] in place,
//     so [row][k2][k1] holds bin N2*k1 + k2: the layout K10 loads, column k2
//     contiguous. Nothing else reads it.
// Bound on the H100: bytes, the input's 8 B a sample read once and the
// spectra's 8 B a bin written once (4.4 GB at [2048, 135000]: 1.30 ms at
// 3.35 TB/s; the 5*N*log2(N) FLOP take 0.35 ms at 67 TFLOP/s). The columns'
// results pass through device memory once more (24 B a bin in all).
//
// The max pass: for each channel, every pair (i < j) of its B receivers,
// max |X_i * conj(X_j)| over all N bins (the PHAT gate's eps * max|R|),
// each receiver's spectrum read once a channel, the max taken over |R|^2
// and its square root once (the same value); a block's maxima meet in
// shared memory and then by atomicMax (non-negative floats order as their
// bits) in the zeroed output. Bound: bytes, 8 B a bin a receiver.
//
// K10, the pair window: one block a pair, a channel's pairs adjacent in the
// grid (its B spectra stay in L2 while they run). Output lag k = k1 +
// N1*k2 and bin n = N2*n1 + n2 give
//   r[lag] = sum_{n2} W_N^{-n2*lag} * Y_{n2}[lag mod N1],
//   Y_{n2}[k1] = sum_{n1} Wh[N2*n1 + n2] * W_N1^{-n1*k1},
// for |lag| <= L with N1 >= 2L + 1 (lags 0..L are k2 = 0, k1 = lag; lags
// -L..-1 are k2 = N2 - 1, k1 = N1 + lag). So the block walks the pair's N2
// columns: it forms R = X_i * conj(X_j) and whitens it, Wh = R / (|R| +
// eps*max|R| + 1e-30) (the reference's PHAT, in its order) in the first
// pass's loads, runs the N1-point inverse FFT in shared memory, and adds
// each output times W_N^{-n2*lag} to the 2L+1 accumulators its thread holds
// in registers (the last pass's outputs stay with their thread). Then |r|/N
// of each lag: [chans, P, 2L+1], the window the lag pick reads. The inverse
// is pruned to the window only in its last factor: N2 * N1-point FFTs and
// (2L+1) * N2 multiply-adds a pair, against an N-point inverse.
// Bound: the pruned inverse's FLOP (54 GFLOP at [256, 28, 1025]: 0.81 ms at
// 67 TFLOP/s) above the bytes of each channel's spectra read once (its
// pairs' re-reads hit L2) and the window written. It runs far above that,
// at about one instruction a cycle an SM: each column's passes wait at
// their barriers and on the first pass's L2 loads (PERF.md).

#include <cuda_runtime.h>

#include "mixed_fft.cuh"

namespace {

using namespace rm_mfft;

// The plans: first radix, then the middle passes (in place in shared
// memory), last radix and its NS. pair_fft.PLANS holds the same.
struct P1080 {  // 1080 = 5 * 3 * 3 * 8 * 3
  // Radix 3 last: K10's last pass is 360 butterflies of 3 outputs, so a
  // thread holds 9 accumulators in 3 rounds of 128 (radix 8 last: 16 in
  // 2 rounds, the second of 7 threads). On an H100 (700 W) this cut K10
  // from 18.2 to 16.4 ms and K9 from 4.2 to 3.8 at [2048, 135000] (K10
  // at 152 registers, not 160).
  static constexpr int N = 1080, R0 = 5, RL = 3, NSL = 360;
  template <int G, int CS, int T, bool INV>
  static __device__ __forceinline__ void middle(float2* buf, const float2* __restrict__ roots) {
    smem_passes<N, R0, G, CS, T, INV, 3, 3, 8>(buf, roots);
  }
};

struct P125 {  // 125 = 5 * 5 * 5
  static constexpr int N = 125, R0 = 5, RL = 5, NSL = 25;
  template <int G, int CS, int T, bool INV>
  static __device__ __forceinline__ void middle(float2* buf, const float2* __restrict__ roots) {
    smem_passes<N, R0, G, CS, T, INV, 5>(buf, roots);
  }
};

struct P16 {  // 16 = 4 * 4
  static constexpr int N = 16, R0 = 4, RL = 4, NSL = 4;
  template <int G, int CS, int T, bool INV>
  static __device__ __forceinline__ void middle(float2*, const float2* __restrict__) {}
};

constexpr int COLS_T = 256;  // K9 columns: threads a block
constexpr int COLS_W = 40;   // K9 columns: consecutive t1 a block
constexpr int ROWS_T = 128;  // K9 rows
constexpr int MAX_T = 256;   // the max pass
constexpr int MAX_SPLIT = 8; // the max pass: blocks a channel
constexpr int WIN_T = 128;   // K10

// R = x * conj(y), as the reference forms it.
__device__ __forceinline__ float2 cross(float2 x, float2 y) {
  return make_float2(x.x * y.x + x.y * y.y, x.y * y.x - x.x * y.y);
}

__device__ __forceinline__ float magnitude(float2 r) { return sqrtf(r.x * r.x + r.y * r.y); }

template <class P1, class P2>
__global__ void __launch_bounds__(COLS_T)
k9_columns(const float* __restrict__ xre, const float* __restrict__ xim, long long row_stride, int elem_stride,
           int len, float2* __restrict__ spec, const float2* __restrict__ roots2, const float2* __restrict__ hi,
           const float2* __restrict__ lo) {
  constexpr int N1 = P1::N, N2 = P2::N, CS = N2 % 2 ? N2 : N2 + 1;  // odd column stride: no bank conflicts
  static_assert(N1 % COLS_W == 0, "whole column tiles");
  __shared__ float2 buf[COLS_W * CS];
  const long long row = blockIdx.y;
  const int t0 = static_cast<int>(blockIdx.x) * COLS_W;
  const float* pre = xre + row * row_stride;
  const float* pim = xim + row * row_stride;
  for (int i = static_cast<int>(threadIdx.x); i < COLS_W * N2; i += COLS_T) {
    const int g = i % COLS_W, t2 = i / COLS_W, ts = t0 + g + N1 * t2;
    float2 x = make_float2(0.0f, 0.0f);
    if (ts < len) {
      const long long a = static_cast<long long>(ts) * elem_stride;
      x = make_float2(pre[a], pim[a]);
    }
    buf[g * CS + t2] = x;
  }
  __syncthreads();
  auto load = [&](int g, int i) { return buf[g * CS + i]; };
  pass<N2, P2::R0, 1, COLS_W, COLS_T, false>(load, [&](int g, int i, float2 x) { buf[g * CS + i] = x; }, roots2);
  P2::template middle<COLS_W, CS, COLS_T, false>(buf, roots2);
  float2* out = spec + row * (static_cast<long long>(N1) * N2);
  pass<N2, P2::RL, P2::NSL, COLS_W, COLS_T, false>(
      load,
      [&](int g, int k2, float2 x) {
        const int t1 = t0 + g;
        out[static_cast<long long>(k2) * N1 + t1] = cmul(x, omega<false>(t1 * k2, hi, lo));
      },
      roots2);
}

template <class P1>
__global__ void __launch_bounds__(ROWS_T) k9_rows(float2* __restrict__ spec, const float2* __restrict__ roots1) {
  constexpr int N1 = P1::N;
  __shared__ float2 buf[N1];
  float2* col = spec + static_cast<long long>(blockIdx.x) * N1;
  // every read of the column happens in the first pass, before its barrier,
  // and the block owns the column: so the last pass may overwrite it
  pass<N1, P1::R0, 1, 1, ROWS_T, false>([&](int, int i) { return col[i]; },
                                        [&](int, int i, float2 x) { buf[i] = x; }, roots1);
  P1::template middle<1, N1, ROWS_T, false>(buf, roots1);
  pass<N1, P1::RL, P1::NSL, 1, ROWS_T, false>([&](int, int i) { return buf[i]; },
                                              [&](int, int i, float2 x) { col[i] = x; }, roots1);
}

template <int B>
__global__ void __launch_bounds__(MAX_T) pair_max(const float2* __restrict__ spec, int n, float* __restrict__ pmax) {
  constexpr int P = B * (B - 1) / 2;
  __shared__ unsigned int smax[P];
  if (threadIdx.x < P) smax[threadIdx.x] = 0u;
  __syncthreads();
  const float2* base = spec + static_cast<long long>(blockIdx.y) * B * n;
  float m[P];
#pragma unroll
  for (int p = 0; p < P; ++p) m[p] = 0.0f;
  for (int i = static_cast<int>(blockIdx.x * MAX_T + threadIdx.x); i < n; i += static_cast<int>(gridDim.x) * MAX_T) {
    float2 x[B];
#pragma unroll
    for (int b = 0; b < B; ++b) x[b] = base[static_cast<long long>(b) * n + i];
    int p = 0;
#pragma unroll
    for (int a = 0; a < B; ++a) {
#pragma unroll
      for (int b = a + 1; b < B; ++b) {
        const float2 r = cross(x[a], x[b]);
        m[p] = fmaxf(m[p], r.x * r.x + r.y * r.y);
        ++p;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float v = sqrtf(m[p]);  // the max of |R|: sqrt is monotone and correctly rounded
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((threadIdx.x & 31) == 0) atomicMax(&smax[p], __float_as_uint(v));
  }
  __syncthreads();
  if (threadIdx.x < P)
    atomicMax(reinterpret_cast<unsigned int*>(pmax) + blockIdx.y * P + threadIdx.x, smax[threadIdx.x]);
}

template <class P1, class P2>
__global__ void __launch_bounds__(WIN_T)
k10_window(const float2* __restrict__ spec, const float* __restrict__ pmax, const int* __restrict__ pairs,
           int num_pairs, int receivers, int max_lag, float eps, float* __restrict__ out,
           const float2* __restrict__ roots1, const float2* __restrict__ hi, const float2* __restrict__ lo) {
  constexpr int N1 = P1::N, N2 = P2::N, N = N1 * N2;
  constexpr int RL = P1::RL, ML = N1 / RL, QL = (ML + WIN_T - 1) / WIN_T;
  static_assert(P1::NSL == ML, "the last pass's outputs are j + r*ML");
  __shared__ float2 buf[N1];
  __shared__ float2 sroots[N1];
  const int t = static_cast<int>(threadIdx.x);
  const int pair = static_cast<int>(blockIdx.x);
  const int c = pair / num_pairs, p = pair % num_pairs;
  const float2* xi = spec + (static_cast<long long>(c) * receivers + pairs[2 * p]) * N;
  const float2* xj = spec + (static_cast<long long>(c) * receivers + pairs[2 * p + 1]) * N;
  const float epsmax = eps * pmax[pair];
  for (int i = t; i < N1; i += WIN_T) sroots[i] = roots1[i];  // read after the first pass's barriers
  float2 acc[QL][RL];
#pragma unroll
  for (int q = 0; q < QL; ++q)
#pragma unroll
    for (int r = 0; r < RL; ++r) acc[q][r] = make_float2(0.0f, 0.0f);

  for (int n2 = 0; n2 < N2; ++n2) {
    const float2* ci = xi + static_cast<long long>(n2) * N1;
    const float2* cj = xj + static_cast<long long>(n2) * N1;
    pass<N1, P1::R0, 1, 1, WIN_T, true>(
        [&](int, int i) {
          const float2 r = cross(ci[i], cj[i]);
          const float den = magnitude(r) + epsmax + 1e-30f;
          return make_float2(r.x / den, r.y / den);
        },
        [&](int, int i, float2 x) { buf[i] = x; }, sroots);
    P1::template middle<1, N1, WIN_T, true>(buf, sroots);
    // the last pass: butterfly j's output r is k1 = j + r*ML; its lag's
    // accumulator takes it times W_N^{-n2*lag}. The next column's first
    // pass synchronises before it stores into buf.
#pragma unroll
    for (int q = 0; q < QL; ++q) {
      const int j = t + q * WIN_T;
      if (ML % WIN_T == 0 || j < ML) {
        float2 v[RL];
#pragma unroll
        for (int r = 0; r < RL; ++r) v[r] = buf[j + r * ML];
        butterfly<N1, RL, ML, true>(v, j, sroots);
#pragma unroll
        for (int r = 0; r < RL; ++r) {
          const int k1 = j + r * ML;
          const int lag = k1 <= max_lag ? k1 : k1 - N1;
          if (lag >= -max_lag) {
            int e = n2 * lag;
            if (e < 0) e += N;
            acc[q][r] = cadd(acc[q][r], cmul(v[r], omega<true>(e, hi, lo)));
          }
        }
      }
    }
  }
  float* w = out + static_cast<long long>(pair) * (2 * max_lag + 1);
#pragma unroll
  for (int q = 0; q < QL; ++q) {
    const int j = t + q * WIN_T;
    if (ML % WIN_T == 0 || j < ML) {
#pragma unroll
      for (int r = 0; r < RL; ++r) {
        const int k1 = j + r * ML;
        const int lag = k1 <= max_lag ? k1 : k1 - N1;
        if (lag >= -max_lag) {
          const float re = acc[q][r].x / static_cast<float>(N), im = acc[q][r].y / static_cast<float>(N);
          w[lag + max_lag] = sqrtf(re * re + im * im);
        }
      }
    }
  }
}

template <class P1, class P2>
int spectra(const float* xre, const float* xim, long long row_stride, int elem_stride, int rows, int len,
            float2* spec, const float2* roots1, const float2* roots2, const float2* hi, const float2* lo,
            cudaStream_t stream) {
  k9_columns<P1, P2><<<dim3(P1::N / COLS_W, rows), COLS_T, 0, stream>>>(xre, xim, row_stride, elem_stride, len,
                                                                         spec, roots2, hi, lo);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  k9_rows<P1><<<rows * P2::N, ROWS_T, 0, stream>>>(spec, roots1);
  return static_cast<int>(cudaGetLastError());
}

template <int B>
int max_pass(const float2* spec, int chans, int n, float* pmax, cudaStream_t stream) {
  pair_max<B><<<dim3(MAX_SPLIT, chans), MAX_T, 0, stream>>>(spec, n, pmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K9: spectra [rows][N2][N1] (float2) of the rows x[row*row_stride +
// t*elem_stride], t < len, zero-padded to N = n1*n2 (len <= N).
extern "C" int rm_pair_fft_spectra(const float* xre, const float* xim, long long row_stride, int elem_stride,
                                   int rows, int len, int n1, int n2, float2* spec, const float2* roots1,
                                   const float2* roots2, const float2* hi, const float2* lo, cudaStream_t stream) {
  if (rows <= 0 || rows > 65535 || len <= 0 || len > n1 * n2) return static_cast<int>(cudaErrorInvalidValue);
  if (n1 == 1080 && n2 == 125)
    return spectra<P1080, P125>(xre, xim, row_stride, elem_stride, rows, len, spec, roots1, roots2, hi, lo, stream);
  if (n1 == 1080 && n2 == 16)
    return spectra<P1080, P16>(xre, xim, row_stride, elem_stride, rows, len, spec, roots1, roots2, hi, lo, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The max pass: pmax [chans][B(B-1)/2] (zeroed by the caller) of K9's
// spectra [chans][B][n].
extern "C" int rm_pair_fft_max(const float2* spec, int chans, int receivers, int n, float* pmax,
                               cudaStream_t stream) {
  if (chans <= 0 || chans > 65535 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (receivers) {
    case 2: return max_pass<2>(spec, chans, n, pmax, stream);
    case 3: return max_pass<3>(spec, chans, n, pmax, stream);
    case 4: return max_pass<4>(spec, chans, n, pmax, stream);
    case 5: return max_pass<5>(spec, chans, n, pmax, stream);
    case 6: return max_pass<6>(spec, chans, n, pmax, stream);
    case 7: return max_pass<7>(spec, chans, n, pmax, stream);
    case 8: return max_pass<8>(spec, chans, n, pmax, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K10: |r| [chans][P][2L+1] of every pair (pairs [P][2], receiver indices)
// from K9's spectra [chans][B][N2][N1] and the max pass's pmax [chans][P].
extern "C" int rm_pair_fft_window(const float2* spec, const float* pmax, const int* pairs, int chans, int receivers,
                                  int num_pairs, int max_lag, float eps, int n1, int n2, float* out,
                                  const float2* roots1, const float2* hi, const float2* lo, cudaStream_t stream) {
  const long long blocks = static_cast<long long>(chans) * num_pairs;
  if (blocks <= 0 || blocks > 2147483647LL || max_lag < 0 || 2 * max_lag + 1 > n1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n1 == 1080 && n2 == 125) {
    k10_window<P1080, P125><<<static_cast<unsigned>(blocks), WIN_T, 0, stream>>>(
        spec, pmax, pairs, num_pairs, receivers, max_lag, eps, out, roots1, hi, lo);
    return static_cast<int>(cudaGetLastError());
  }
  if (n1 == 1080 && n2 == 16) {
    k10_window<P1080, P16><<<static_cast<unsigned>(blocks), WIN_T, 0, stream>>>(
        spec, pmax, pairs, num_pairs, receivers, max_lag, eps, out, roots1, hi, lo);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
