// Kernel K3 for rows longer than one block's shared memory, n1 = 128 or
// 256: forward CT-order FFT of [rows, n] rows, n = n1*n2 with n2 = 8*r <=
// 1024, one row a thread-block cluster of c = 2, 4 or 8 blocks, in one
// pass through device memory. (Long rows with n1 = 384, 640 or 896 take
// the wide design, fft_detect_cluster.cuh.)
//
// Replaces radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows_ct (body
// fft_kernel.ct_fft_core) above n = 24576, where the one-block design
// (fft_rows_ct.cu) no longer holds a row. Python wrapper:
// radio_mapper_tpu_torch/ops/cuda/fft_rows.py (long_rows; long_geometry
// picks c); kernels K1's long rows and K8's long design run it too.
// tests/test_torch_cluster_fft.py replays the column ownership and the
// DSMEM pull map in numpy, tests/test_torch_long_rows_radix.py step B's
// thread map.
//
// The four-step split of ct_fft.cuh, with the per-value arithmetic of the
// one-block design; only the data movement differs:
//
//   columns   block `rank` owns columns [rank*n1/c, (rank+1)*n1/c), held
//             as tiles of COLS columns, [tile][n2][COLS] float2 (COLS = 32
//             where n2 <= 512 and 32 divides n1/c, else 16). It loads them,
//             then runs steps A and B in place on each tile: step A as
//             ct_fft.cuh's step_a; step B (step_b_tile) on the column
//             blocks in two rounds of four, a lane two columns and up to
//             four output pairs, so every output of a round is held in
//             registers until one barrier ends the round's reads.
//   cluster barrier.
//   rows      the block takes slot rows [rank*n2/c, (rank+1)*n2/c), each
//             warp one or two at a time. Lane l gathers its P = n1/32
//             points, positions P*l + i, from the blocks that own them
//             through DSMEM (P/2 16-byte loads; an even position and the
//             next never cross a tile or a block), all issued before the
//             first shuffle. Then step C (ct_fft.cuh step_c_regs: five
//             radix-2 stages across lanes, the P-point transform in
//             registers) and the store at CT row k + a*s, as the one-block
//             K3 stores it.
//   cluster barrier: no block exits while a partner reads it.
//
// c is the least of 2, 4, 8 for which two blocks' n*8/c bytes (and the
// 64-entry W_128 table) fit one SM, so two 512-thread blocks an SM (64
// registers a thread) hide each other's loads and barriers; where none
// does (n > 113664), the least for which one block fits 227 KB.
//
// Each sample is read once and its spectrum written once, 16 B a sample
// (the workspace design moves 32), and the spectra equal the workspace
// design's and, where both take a length, the one-block design's bit for
// bit (card tests, tools/forward_times.py digests). Bound on the H100:
// device-memory bytes, 0.165 ms at [1024, 33792] at 3.35 TB/s; the direct
// r-point DFT of step B is most of the time (PERF.md).

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "ct_fft.cuh"

namespace {

using rm_fft::THREADS;  // 512 a block; two blocks an SM where their shared memory fits (64 registers)
using rm_fft::WARPS;

constexpr int A = 8;              // every long split has 8 | n2
constexpr int MAX_N2 = 1024;      // ct_plan.ct_split's largest n2
constexpr int STEP_B_ROUNDS = 2;  // step B takes the column blocks in two rounds of four
constexpr int STEP_B_NP = 4;      // step B's output pairs a lane a round: PER_K*4 pairs >= r/2 for every n2 <= 1024
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block

// Step B on one tile of COLS columns held as ts[q*COLS + p], in place, in
// two rounds of four column blocks. A lane takes a pair of columns p, p + 1;
// owner o (a group of COLS/2 lanes: 32 or 64 a block) takes column block
// k = o / PER_K (+ 4 in the second round) and the output pairs s = 2 sp,
// 2 sp + 1 with sp = sub + PER_K*i, i < 4 (sub = o mod PER_K). For each
// pair, a pass over j = 0..r-1 reads y_j of both columns as one 16-byte
// load and the roots W_r^(j*s), W_r^(j*(s+1)) as one 16-byte load of wp
// (wr with rows padded to even length), then runs 4 cmacs. So each output
// is step_b's: acc = sum over j of cmac(acc, W_r^(j*s), y_j) from zero, in
// j order, then times the row twiddle; the values equal the one-block
// design's bit for bit. A round's outputs (at most 16 a thread) stay in
// registers until one barrier ends every read of its column blocks.
template <int COLS>
__device__ __forceinline__ void step_b_tile(float2* ts, const float2* __restrict__ wp,
                                            const float2* __restrict__ tw, int tw_ld, int r) {
  constexpr int LANES = COLS / 2;  // a lane a column pair
  constexpr int OWNERS = WARPS * (32 / LANES);
  constexpr int KR = A / STEP_B_ROUNDS;  // column blocks a round
  constexpr int PER_K = OWNERS / KR;
  static_assert(PER_K * STEP_B_NP * 2 >= 2 * 32 * 32 / COLS, "the owners of a column block cover r");
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int owner = (static_cast<int>(threadIdx.x) >> 5) * (32 / LANES) + lane / LANES;
  const int sub = owner % PER_K;
  const int p = 2 * (lane % LANES);
  const int rh = (r + 1) / 2, rp = 2 * rh;  // output pairs; wp's row length
  const float4* w4 = reinterpret_cast<const float4*>(wp);
#pragma unroll 1
  for (int k = owner / PER_K; k < A; k += KR) {
    const float4* col = reinterpret_cast<const float4*>(ts + r * k * COLS + p);
    float2 acc[STEP_B_NP][4];  // pair i: (s, column p), (s, p + 1), (s + 1, p), (s + 1, p + 1)
#pragma unroll
    for (int i = 0; i < STEP_B_NP; ++i) {
      const int sp = sub + PER_K * i;
      if (sp < rh) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = make_float2(0.f, 0.f);
        for (int j = 0; j < r; ++j) {
          const float4 y = col[j * (COLS / 2)];
          const float4 w = __ldg(w4 + (j * rp) / 2 + sp);
          const float2 y0 = make_float2(y.x, y.y), y1 = make_float2(y.z, y.w);
          const float2 wa = make_float2(w.x, w.y), wb = make_float2(w.z, w.w);
          rm_ct::cmac(acc[i][0], wa, y0);
          rm_ct::cmac(acc[i][1], wa, y1);
          rm_ct::cmac(acc[i][2], wb, y0);
          rm_ct::cmac(acc[i][3], wb, y1);
        }
      }
    }
    __syncthreads();  // every read of this round's column blocks is done
#pragma unroll
    for (int i = 0; i < STEP_B_NP; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 2 * (sub + PER_K * i) + e / 2, q = p + e % 2;
        if (s < r) ts[(s + r * k) * COLS + q] = rm_ct::cmul(acc[i][e], __ldg(tw + (k + A * s) * tw_ld + q));
      }
    }
  }
}

// Lane's P = R1/32 points of slot row sr, positions P*lane + i, gathered
// from the tiles of the blocks that own them through DSMEM: P/2 16-byte
// loads (an even position and the next never cross a tile or a block).
template <int R1, int COLS>
__device__ __forceinline__ void gather(const float2* xs, int c, int n2, int sr, float2 (&v)[R1 / 32]) {
  constexpr int P = R1 / 32;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int own = R1 / c;
#pragma unroll
  for (int u = 0; u < P / 2; ++u) {
    const int p = P * lane + 2 * u;
    const int owner = p * c / R1, col = p - owner * own;
    const float4 f = rm_cluster::ld4(rm_cluster::dsmem(
        xs + (static_cast<size_t>(col / COLS) * n2 + sr) * COLS + col % COLS, static_cast<unsigned>(owner)));
    v[2 * u] = make_float2(f.x, f.y);
    v[2 * u + 1] = make_float2(f.z, f.w);
  }
}

template <int R1>
__device__ __forceinline__ void step_c_store(float2 (&v)[R1 / 32], const float2* w1, float* fre, float* fim,
                                             size_t off, int sr, int r) {
  rm_fft::step_c_regs<R1>(v, w1);
#pragma unroll
  for (int k = 0; k < R1 / 32; ++k) {
    const size_t m = off + rm_fft::ct_address<R1>(sr, k, A, r);
    fre[m] = v[k].x;
    fim[m] = v[k].y;
  }
}

template <int R1, int COLS>
__global__ void __launch_bounds__(THREADS, 2)
ct_cluster_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                  const float2* __restrict__ w1, const float2* __restrict__ wn2,
                  const float2* __restrict__ wp, const float2* __restrict__ tw,
                  float* __restrict__ fre, float* __restrict__ fim, int c, int n2, int r) {
  constexpr int P = R1 / 32;
  extern __shared__ float4 smem[];  // float4: the row pass reads 16 bytes at a time
  float2* xs = reinterpret_cast<float2*>(smem);  // [tiles][n2][COLS], this block's columns
  const int own = R1 / c;  // columns a block owns
  const int tiles = own / COLS;
  float2* w128s = xs + static_cast<size_t>(own) * n2;  // [64] W_128^e
  const int rank = static_cast<int>(rm_cluster::rank());
  const int tid = static_cast<int>(threadIdx.x);
  const size_t off = static_cast<size_t>(blockIdx.x / c) * R1 * n2;
  const int c0 = rank * own;

  // ---- this block's columns, tile by tile: tile[q][p] = x[q*n1 + p0 + p]
  for (int t = 0; t < tiles; ++t) {
    const float* xr = xre + off + c0 + t * COLS;
    const float* xi = xim + off + c0 + t * COLS;
    float2* ts = xs + static_cast<size_t>(t) * n2 * COLS;
#pragma unroll 4
    for (int m = tid; m < COLS * n2; m += THREADS) {
      const int q = m / COLS, p = m % COLS;
      ts[m] = make_float2(xr[static_cast<size_t>(q) * R1 + p], xi[static_cast<size_t>(q) * R1 + p]);
    }
  }
  // W_128^e = W_n1^(e*n1/128): the same float32 values, so step A rounds
  // as the one-block design's does
  if (tid < 64) w128s[tid] = w1[tid * (R1 / 128)];
  __syncthreads();

  // ---- steps A and B in place on each tile
  for (int t = 0; t < tiles; ++t) {
    float2* ts = xs + static_cast<size_t>(t) * n2 * COLS;
    rm_fft::step_a<A, COLS>(ts, w128s, wn2, r);
    __syncthreads();
    step_b_tile<COLS>(ts, wp, tw + c0 + t * COLS, R1, r);
    __syncthreads();
  }
  rm_cluster::sync();  // every block's slot rows are complete

  // ---- step C on slot rows [rank*n2/c, (rank+1)*n2/c), gathered through
  // DSMEM, ROWS slot rows a warp in flight (their loads issued first)
  constexpr int ROWS = P <= 4 ? 2 : 1;
  const int per = n2 / c;
  const int sr0 = rank * per;
  for (int i = tid >> 5; i < per; i += ROWS * WARPS) {
    float2 v[ROWS][P];
#pragma unroll
    for (int b = 0; b < ROWS; ++b)
      if (i + b * WARPS < per) gather<R1, COLS>(xs, c, n2, sr0 + i + b * WARPS, v[b]);
#pragma unroll
    for (int b = 0; b < ROWS; ++b)
      if (i + b * WARPS < per) step_c_store<R1>(v[b], w1, fre, fim, off, sr0 + i + b * WARPS, r);
  }
  rm_cluster::sync();  // no block exits while a partner reads its columns
}

size_t smem_bytes(int n1, int n2, int c) { return (static_cast<size_t>(n1 / c) * n2 + 64) * sizeof(float2); }

// The column tile of a block that owns n1/c columns (long_geometry's rule).
int cols_for(int n1, int n2, int c) { return (n2 <= 512 && (n1 / c) % 32 == 0) ? 32 : 16; }

using Kernel = void (*)(const float*, const float*, const float2*, const float2*, const float2*,
                        const float2*, float*, float*, int, int, int);

// The instantiation for (n1, COLS): only those the planned lengths reach
// (fft_rows.long_geometry; tests/test_torch_long_rows_radix.py lists
// them), nullptr otherwise.
Kernel variant(int n1, int cols) {
  if (n1 == 128 && cols == 32) return ct_cluster_kernel<128, 32>;
  if (n1 == 128 && cols == 16) return ct_cluster_kernel<128, 16>;
  if (n1 == 256 && cols == 32) return ct_cluster_kernel<256, 32>;
  return nullptr;
}

// The kernel for a row of n1*n2 = n1*8*r on clusters of c, or nullptr
// where the shape is not one this design takes.
Kernel kernel_for(int n1, int n2, int a, int r, int c) {
  if (a != A || a * r != n2 || n2 > MAX_N2 || (c != 2 && c != 4 && c != 8)) return nullptr;
  if (n1 % (16 * c) != 0 || n2 % c != 0 || smem_bytes(n1, n2, c) > SMEM_LIMIT) return nullptr;
  return variant(n1, cols_for(n1, n2, c));
}

}  // namespace

// w1: W_n1^e (e < n1/2); wn2, wr, tw: ct_plan.radix_tables and
// ct_constants' twiddle for this n; c: the cluster's blocks
// (fft_rows.long_geometry).
extern "C" int rm_fft_rows_ct_cluster(const float* xre, const float* xim, const float2* w1, const float2* wn2,
                                      const float2* wr, const float2* tw, float* fre, float* fim, int rows,
                                      int n1, int n2, int a, int r, int c, cudaStream_t stream) {
  const Kernel k = kernel_for(n1, n2, a, r, c);
  if (k == nullptr || rows <= 0 || rows > 0x7fffffff / c) return static_cast<int>(cudaErrorInvalidValue);
  return rm_cluster::launch(k, rows * c, THREADS, smem_bytes(n1, n2, c), c, stream,
                            xre, xim, w1, wn2, wr, tw, fre, fim, c, n2, r);
}

// The cluster's shape: shared memory a block and cudaOccupancyMaxActiveClusters.
extern "C" int rm_fft_rows_ct_cluster_info(int n1, int n2, int a, int r, int c, int* smem, int* clusters) {
  const Kernel k = kernel_for(n1, n2, a, r, c);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *smem = static_cast<int>(smem_bytes(n1, n2, c));
  return static_cast<int>(rm_cluster::occupancy(k, THREADS, smem_bytes(n1, n2, c), c, clusters));
}
