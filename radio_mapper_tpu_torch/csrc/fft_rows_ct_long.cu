// The workspace design of kernel K3's long rows, n1 = 384, 640 or 896
// (the mixed-radix row pass, P = 12, 20, 28 points a lane): forward
// CT-order FFT of [rows, n] rows, n = n1*n2 with n2 = 8*r <= 512 (every
// such planned length's split), in two passes through a device-memory
// workspace. No route reaches it: rows with these n1 take the wide design
// (fft_detect_cluster.cuh, K1's one-pass kernel, with its detect half off
// for K3), routed by n1 (fft_rows.long_geometry), and rows with n1 = 128
// or 256 the thread-block cluster design (fft_rows_ct_cluster.cu). It
// stays built as the wide design's comparison only
// (fft_rows.workspace_rows: the card tests, chip_smoke.py phase 20,
// tools/forward_times.py), which must equal it bit for bit.
//
// Replaced radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows_ct (body
// fft_kernel.ct_fft_core) at those lengths before the wide design. Python
// wrapper: radio_mapper_tpu_torch/ops/cuda/fft_rows.py (workspace_rows).
//
// The four-step split of ct_fft.cuh, with the per-value arithmetic of the
// one-block design; only the data movement differs:
//
//   column pass  a block takes a tile of 32 columns p of one row, loads
//                x[q][p] for every q < n2, runs steps A and B on the tile
//                (step A 8-point; step B's r inputs in registers for
//                r <= 24, streamed from shared memory above, 2 or 3
//                outputs a thread) and writes the slot rows s + r*k, times
//                the row twiddle, to the workspace ws[row][s + r*k][p];
//   row pass     one warp a workspace slot row runs step C, the n1-point
//                FFT: five radix-2 stages across lanes and a P-point
//                transform in registers (P = n1/32 = 4q, two radix-2
//                stages and a direct q-point DFT, q = 3, 5, 7), and stores
//                the row at CT row k + a*s, coalesced, as the one-block K3
//                stores it.
//
// The workspace cannot be the output planes: slot row s + r*k and CT row
// k + a*s are different rows, written by different blocks.
//
// Bound on the H100: device-memory bytes. Each sample is read and written
// twice (32 B a sample, against 16 B for the one-block and cluster
// designs).

#include <cuda_runtime.h>

#include "ct_fft.cuh"

namespace {

using rm_fft::THREADS;

constexpr int ROW_THREADS = 256;  // the row pass: one warp a slot row
constexpr int MAX_N2 = 512;       // n2 of these lengths (at most 336 up to 131072)

// RMAX > 0: step B holds up to RMAX inputs in registers; RMAX == 0: it
// streams them from shared memory, SJ outputs a thread a pass.
template <int A, int RMAX, int COLS, int SJ>
__global__ void __launch_bounds__(THREADS, (RMAX > 0 ? RMAX <= 16 : SJ <= 8) ? 2 : 1)
ct_columns_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                  const float2* __restrict__ w1, const float2* __restrict__ wn2,
                  const float2* __restrict__ wr, const float2* __restrict__ tw,
                  float2* __restrict__ ws, int n1, int n2, int r) {
  extern __shared__ float2 tile[];  // [n2][COLS] slot rows of the tile, then [64] W_128
  float2* w128s = tile + COLS * n2;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * COLS;
  const size_t off = static_cast<size_t>(blockIdx.y) * n1 * n2;
  const float* xr = xre + off + p0;
  const float* xi = xim + off + p0;

  for (int m = tid; m < COLS * n2; m += THREADS) {
    const int q = m / COLS, p = m - q * COLS;
    tile[m] = make_float2(xr[static_cast<size_t>(q) * n1 + p], xi[static_cast<size_t>(q) * n1 + p]);
  }
  // W_128^e = W_n1^(e*n1/128): the same float32 values (the angles are
  // equal in float64), so step A rounds as the one-block design's does
  if (tid < 64) w128s[tid] = w1[tid * (n1 / 128)];
  __syncthreads();

  if constexpr (A > 1) {
    rm_fft::step_a<A, COLS>(tile, w128s, wn2, r);
    __syncthreads();
  }
  float2* dst = ws + off + p0;  // slot row sr of this row at dst[sr * n1]
  if constexpr (RMAX > 0) {
    rm_fft::step_b<A, RMAX, COLS>(tile, wr, tw + p0, n1, dst, n1, r);
  } else {
    rm_fft::step_b_stream<A, COLS, SJ>(tile, wr, tw + p0, n1, dst, n1, r);
  }
}

template <int R1>
__global__ void __launch_bounds__(ROW_THREADS)
ct_rows_kernel(const float2* __restrict__ ws, const float2* __restrict__ w1, float* __restrict__ fre,
               float* __restrict__ fim, int rows, int n2, int a, int r) {
  const size_t g = static_cast<size_t>(blockIdx.x) * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (g >= static_cast<size_t>(rows) * n2) return;  // whole warps: the shuffles stay full
  const size_t row = g / n2;
  const int sr = static_cast<int>(g - row * n2);
  float2 v[R1 / 32];
  rm_fft::step_c_row<R1>(ws + g * R1, w1, v);
  const size_t off = row * n2 * R1;
#pragma unroll
  for (int i = 0; i < R1 / 32; ++i) {
    const size_t m = off + rm_fft::ct_address<R1>(sr, i, a, r);
    fre[m] = v[i].x;
    fim[m] = v[i].y;
  }
}

template <int A, int RMAX, int COLS, int SJ = 0>
int launch_columns(const float* xre, const float* xim, const float2* w1, const float2* wn2, const float2* wr,
                   const float2* tw, float2* ws, int rows, int n1, int n2, int r, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(COLS) * n2 + 64) * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(ct_columns_kernel<A, RMAX, COLS, SJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n1 / COLS, rows);
  ct_columns_kernel<A, RMAX, COLS, SJ><<<grid, THREADS, smem, stream>>>(xre, xim, w1, wn2, wr, tw, ws, n1, n2, r);
  return static_cast<int>(cudaGetLastError());
}

// Step B's variant for r, a = 8, 32 columns: inputs in registers up to
// r = 24; streamed above, with as many outputs a thread as r needs in one
// pass (OWNERS*SJ >= r). Only the variants the planned lengths reach are
// built (fft_rows.long_geometry; r <= 42 at n2 <= 336).
int launch_columns_32(const float* xre, const float* xim, const float2* w1, const float2* wn2, const float2* wr,
                      const float2* tw, float2* ws, int rows, int n1, int n2, int r, cudaStream_t stream) {
  constexpr int OWNERS = rm_fft::WARPS;  // one 32-lane owner a warp
  if (r <= 24) return launch_columns<8, 24, 32>(xre, xim, w1, wn2, wr, tw, ws, rows, n1, n2, r, stream);
  if (r <= 2 * OWNERS) return launch_columns<8, 0, 32, 2>(xre, xim, w1, wn2, wr, tw, ws, rows, n1, n2, r, stream);
  if (r <= 3 * OWNERS) return launch_columns<8, 0, 32, 3>(xre, xim, w1, wn2, wr, tw, ws, rows, n1, n2, r, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int R1>
int launch_rows(const float2* ws, const float2* w1, float* fre, float* fim, int rows, int n2, int a, int r,
                cudaStream_t stream) {
  const size_t warps = static_cast<size_t>(rows) * n2;
  const size_t blocks = (warps + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32);
  ct_rows_kernel<R1><<<static_cast<unsigned>(blocks), ROW_THREADS, 0, stream>>>(ws, w1, fre, fim, rows, n2, a, r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w1: W_n1^e (e < n1/2); wn2, wr, tw: ct_plan.radix_tables and ct_constants'
// twiddle for this n; ws: [rows, n2, n1] float2 workspace.
extern "C" int rm_fft_rows_ct_long(const float* xre, const float* xim, const float2* w1, const float2* wn2,
                                   const float2* wr, const float2* tw, float2* ws, float* fre, float* fim,
                                   int rows, int n1, int n2, int a, int r, cudaStream_t stream) {
  if (a != 8 || a * r != n2 || n2 > MAX_N2 || (n1 != 384 && n1 != 640 && n1 != 896))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_columns_32(xre, xim, w1, wn2, wr, tw, ws, rows, n1, n2, r, stream);
  if (err != 0) return err;
  switch (n1) {
    case 384: return launch_rows<384>(ws, w1, fre, fim, rows, n2, a, r, stream);
    case 640: return launch_rows<640>(ws, w1, fre, fim, rows, n2, a, r, stream);
    default: return launch_rows<896>(ws, w1, fre, fim, rows, n2, a, r, stream);
  }
}
