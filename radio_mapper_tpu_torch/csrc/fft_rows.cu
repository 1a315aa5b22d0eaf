// Kernel K7, tiled design: natural-order four-step forward FFT of
// [rows, n] rows too long for one SM (32768 and 65536 on the routed path;
// fft_natural.design(n) == "tiled"). Rows of 4096-16384 points take the
// one-launch radix design, fft_natural_radix.cu.
//
// Replaces radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows (body
// _fft_rows_kernel). Python wrapper, tables and plain PyTorch version:
// radio_mapper_tpu_torch/ops/cuda/fft_natural.py.
//
// Split (fft_kernel._split): n = n1*n2, n2 the largest divisor <= sqrt(n),
// n1 = n/n2 <= 256; a row is x[q][j] at time j + n1*q. Bin k = k2 + n2*k1:
//   S[j][k2]  = TW[j][k2] * sum_q x[q][j] W2[q][k2]   (inner n2-point DFT, twiddle)
//   X[k1][k2] = sum_j W1[k1][j] S[j][k2]              (outer n1-point DFT)
// and X[k1][k2] at k1*n2 + k2 IS natural order: the [k2, k1] -> [k1, k2]
// transpose of the TPU kernel's output merge is folded into pass 1, which
// reads x transposed (x[q][j] is the k-major A operand) and writes S with
// k2 minor.
//
// Design: two passes through device memory, one launch each of the same
// complex tiled product C[m][n] = T[m][n] * sum_k A[k][m] B[k][n] (planar
// re/im, 64x64 output tile per 256-thread block, 16-deep k tiles staged in
// 16 KB of shared memory, 4x4 outputs per thread). Pass 1: A = x, B = W2,
// T = TW^T, C = S (scratch). Pass 2: A = W1 (symmetric, so W1[k1][j] is
// the k-major element (j, k1)), B = S, C = the spectrum. Every global
// load and store is row-contiguous across a warp.
//
// Why two passes and not one row per block: a complex row is 256 KiB at
// 32768 and 512 KiB at 65536, beyond the 227 KB a block can hold. The
// scratch adds 16 B of traffic per point against 8*(n1+n2) FP32 FMAs per
// point (3,072 at n = 32768), so the extra pass costs little next to the
// direct DFT stages.
//
// Bound on the H100: the direct DFT stages, n*(n1+n2) complex FMAs per
// row (12.6 M at 32768 = 256*128), FP32 on the CUDA cores from shared
// memory. Queued (ROADMAP R2b): the radix design's passes on a row held
// in a thread-block cluster's distributed shared memory.

#include <cuda_runtime.h>

#include "ct_dft.cuh"

namespace {

constexpr int K7_THREADS = 256;  // fft_natural.THREADS
constexpr int K7_TILE = 64;      // output tile edge; fft_natural.TILE: n1 and n2 are multiples
constexpr int K7_BK = 16;        // k depth per shared-memory stage
constexpr int K7_R = K7_TILE / 16;  // 4x4 outputs per thread

// C[z][m][n] = T[m][n] * sum_k A[z][k][m] B[z][k][n], complex, planar.
// A element (k, m) at a*[z*a_batch + k*lda + m]; B (k, n) at
// b*[z*b_batch + k*ldb + n]; C and T (m, n) at [z*c_batch +] m*ldc + n.
// Block x runs tile (tm, tn) of row z; M, N multiples of K7_TILE, K of K7_BK.
__global__ void __launch_bounds__(K7_THREADS)
cgemm_tile_kernel(const float* __restrict__ are, const float* __restrict__ aim, long long a_batch,
                  int lda, const float* __restrict__ bre, const float* __restrict__ bim,
                  long long b_batch, int ldb, const float* __restrict__ tre,
                  const float* __restrict__ tim, float* __restrict__ cre, float* __restrict__ cim,
                  long long c_batch, int ldc, int m_tiles, int n_tiles, int k) {
  __shared__ float2 as[K7_BK][K7_TILE];
  __shared__ float2 bs[K7_BK][K7_TILE];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long blk = blockIdx.x;
  const int tn = static_cast<int>(blk % n_tiles);
  const int tm = static_cast<int>((blk / n_tiles) % m_tiles);
  const long long z = blk / (static_cast<long long>(n_tiles) * m_tiles);
  const int m0 = tm * K7_TILE, n0 = tn * K7_TILE;
  are += z * a_batch;
  aim += z * a_batch;
  bre += z * b_batch;
  bim += z * b_batch;
  cre += z * c_batch;
  cim += z * c_batch;

  float2 acc[K7_R][K7_R];
#pragma unroll
  for (int i = 0; i < K7_R; ++i)
#pragma unroll
    for (int j = 0; j < K7_R; ++j) acc[i][j] = make_float2(0.f, 0.f);

  for (int k0 = 0; k0 < k; k0 += K7_BK) {
    // stage A[k0:k0+16][m0:m0+64] and B[k0:k0+16][n0:n0+64]: thread t
    // takes elements t + 256*r, 64 consecutive m (n) per k row
#pragma unroll
    for (int r = 0; r < (K7_BK * K7_TILE) / K7_THREADS; ++r) {
      const int e = tid + K7_THREADS * r;
      const int kk = e / K7_TILE, mm = e % K7_TILE;
      const size_t ai = static_cast<size_t>(k0 + kk) * lda + m0 + mm;
      const size_t bi = static_cast<size_t>(k0 + kk) * ldb + n0 + mm;
      as[kk][mm] = make_float2(are[ai], aim[ai]);
      bs[kk][mm] = make_float2(bre[bi], bim[bi]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < K7_BK; ++kk) {
      float2 a[K7_R], b[K7_R];
#pragma unroll
      for (int i = 0; i < K7_R; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < K7_R; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < K7_R; ++i)
#pragma unroll
        for (int j = 0; j < K7_R; ++j) rm_ct::cmac(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // every read of this stage is done before the next load
  }

#pragma unroll
  for (int i = 0; i < K7_R; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < K7_R; ++j) {
      const size_t ci = static_cast<size_t>(m) * ldc + n0 + tx + 16 * j;
      float2 v = acc[i][j];
      if (tre != nullptr) v = rm_ct::cmul(v, make_float2(__ldg(tre + ci), __ldg(tim + ci)));
      cre[ci] = v.x;
      cim[ci] = v.y;
    }
  }
}

}  // namespace

// Forward FFT of `rows` rows of n = n1*n2 points, natural bin order.
// Tables (planar float32): w1 [n1][n1], w2 [n2][n2], twt [n1][n2] with
// twt[j][k2] = exp(-2 pi i j k2 / n). s: [rows][n1][n2] scratch.
extern "C" int rm_fft_rows(const float* xre, const float* xim, const float* w1re,
                           const float* w1im, const float* w2re, const float* w2im,
                           const float* twtre, const float* twtim, float* sre, float* sim,
                           float* fre, float* fim, int rows, int n1, int n2,
                           cudaStream_t stream) {
  if (rows <= 0 || n1 % K7_TILE != 0 || n2 % K7_TILE != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n1) * n2;
  const int mt = n1 / K7_TILE, nt = n2 / K7_TILE;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(rows) * mt * nt));
  // pass 1: S[j][k2] = TWt[j][k2] * sum_q x[q][j] W2[q][k2]
  cgemm_tile_kernel<<<grid, K7_THREADS, 0, stream>>>(xre, xim, n, n1, w2re, w2im, 0, n2, twtre,
                                                     twtim, sre, sim, n, n2, mt, nt, n2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // pass 2: X[k1][k2] = sum_j W1[j][k1] S[j][k2]
  cgemm_tile_kernel<<<grid, K7_THREADS, 0, stream>>>(w1re, w1im, 0, n1, sre, sim, n, n2, nullptr,
                                                     nullptr, fre, fim, n, n2, mt, nt, n1);
  return static_cast<int>(cudaGetLastError());
}
