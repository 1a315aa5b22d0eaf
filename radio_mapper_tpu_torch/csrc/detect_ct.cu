// Kernel K4: spectral detection on CT-order spectra read from device
// memory, one thread block per row, for any n1 (a multiple of TILE) and n2
// with 8 | n2, without holding the row in shared memory.
//
// Replaces radio_mapper_tpu/ops/pallas/detect_kernel.py::detect_ct_partials
// (detect_kernel._detect_body). Kernel K1's long rows run it after the
// long K3 and take its row max (K4 itself emits none, as the reference's).
// Python wrapper: radio_mapper_tpu_torch/ops/cuda/detect_ct.py. The
// reference's rows_per_block and row padding tile the TPU's VMEM and are
// dropped.
//
// Two phases, with the parts of ct_detect.cuh's detect body:
//
//   phase a  the block reads the row once: the row max, and the stride-8
//            natural subsample's dB values (the CT rows k2 = 0 mod 8, n/8
//            floats, 33 KB at n = 66560) into shared memory; then the
//            24-step bisection of the noise floor over them;
//   phase b  tiles of TILE consecutive columns k1. A column is a run of n2
//            consecutive natural bins k = k2 + n2*k1, so the tile's power,
//            read again from the spectra, is laid out in natural order with
//            a halo of `radius` bins from column k1 - 1 before it and from
//            column k1 + TILE after it (circular at k1 = 0 and n1 - 1;
//            radius <= n2, so one neighbour column holds the halo). Then
//            the sliding max, the gates and the per-8-bin segment partials,
//            segment b2*n1 + k1 being 8 consecutive bins of the tile.
//
//   phase c  (emit_topk = K only) the partials phase b wrote to a device-
//            memory scratch [rows, n/8] x 2 (the wrapper's) are this
//            block's own writes, visible after a barrier: the scores come
//            back to shared memory and ct_detect.cuh's block_topk writes
//            the row's [128] block of top-K values and packed 8*f + offset
//            (detect_kernel._detect_body's emit_topk), in the same launch,
//            an instantiation of its own (TOPK), so the partials-only
//            kernel keeps its registers and occupancy.
//
// Every reduction of the body is a max, a min or an integer count, so the
// tiling changes no output bit: on K1's own spectra the partials, the
// floor and the row max equal K1's bit for bit (card test), and phase c's
// output equals the partials followed by the port's top-K tail.
//
// Bound on the H100: device-memory bytes, the spectra read twice (16 B a
// bin) and the partials written once; the sliding max reads shared memory
// 2*radius + 1 times a bin. At n1 = 384, 640, 896 K1 no longer launches
// it: the wide design (fft_detect_cluster.cuh) runs these parts over a
// thread-block cluster in the transform's launch, and K4 keeps K1's rows
// at n1 = 128, 256 and K1's top-K at 384, 640, 896.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "ct_detect.cuh"

namespace {

constexpr int K4_THREADS = 512;  // detect_ct.THREADS
constexpr int TILE = 16;         // columns k1 a phase-b tile (detect_ct.TILE)

using rm_det::DetectParams;
using rm_det::SEG;

template <bool TOPK>
__global__ void __launch_bounds__(K4_THREADS)
detect_ct_kernel(const float* __restrict__ fre, const float* __restrict__ fim,
                 float* __restrict__ seg_score, float* __restrict__ seg_arg,
                 float* __restrict__ nf_out, float* __restrict__ rmax_out, int n1, int n2,
                 DetectParams prm, int topk, float* __restrict__ top_vals, float* __restrict__ top_packed) {
  extern __shared__ float sbuf[];  // phase a: [n/8] dB subsample; phase b: the tile
  __shared__ float red_f[K4_THREADS / 32];
  __shared__ int red_i[K4_THREADS / 32];
  const int n = n1 * n2, s = n / SEG;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* fr = fre + row * n;
  const float* fi = fim + row * n;

  // ---- phase a: row max and the stride-8 subsample, one read of the row
  float vmax = -CUDART_INF_F, lo = CUDART_INF_F, hi = -CUDART_INF_F;
  for (int m = tid; m < n; m += K4_THREADS) {
    const float p = rm_det::power(fr[m], fi[m]);
    vmax = fmaxf(vmax, p);
    const int k2 = m / n1;
    if (k2 % SEG == 0) {
      const float db = rm_det::sub_db(p, prm);
      sbuf[(k2 / SEG) * n1 + (m - k2 * n1)] = db;
      lo = fminf(lo, db);
      hi = fmaxf(hi, db);
    }
  }
  const float row_max = rm_det::block_reduce<K4_THREADS>(vmax, rm_det::MaxOp(), red_f);
  lo = rm_det::block_reduce<K4_THREADS>(lo, rm_det::MinOp(), red_f);
  hi = rm_det::block_reduce<K4_THREADS>(hi, rm_det::MaxOp(), red_f);
  const float nf = rm_det::bisect_floor<K4_THREADS>(sbuf, s, lo, hi, prm, red_i);
  const float conf_lin = rm_det::conf_level(nf, prm);
  if (tid == 0) {
    nf_out[row] = nf;
    if (rmax_out != nullptr) rmax_out[row] = row_max;
  }

  // ---- phase b: tiles of TILE columns in natural order, with halos
  const int rad = prm.radius;
  float* nat = sbuf;                        // [rad | TILE*n2 | rad] power, natural order
  float* score = sbuf + TILE * n2 + 2 * rad;  // [TILE*n2] candidate scores
  float* sc = seg_score + row * s;
  float* sa = seg_arg + row * s;
  for (int c0 = 0; c0 < n1; c0 += TILE) {
    __syncthreads();  // the previous tile (or the bisection) is done with sbuf
    // consecutive threads read consecutive columns of one CT row
    for (int u = tid; u < TILE * n2; u += K4_THREADS) {
      const int k2 = u / TILE, c = u - k2 * TILE;
      const int m = k2 * n1 + c0 + c;
      nat[rad + c * n2 + k2] = rm_det::power(fr[m], fi[m]);
    }
    const int left = c0 == 0 ? n1 - 1 : c0 - 1;
    const int right = c0 + TILE == n1 ? 0 : c0 + TILE;
    for (int h = tid; h < 2 * rad; h += K4_THREADS) {
      const bool before = h < rad;
      const int k2 = before ? n2 - rad + h : h - rad;  // the column's last / first rad bins
      const int m = k2 * n1 + (before ? left : right);
      nat[before ? h : TILE * n2 + rad + (h - rad)] = rm_det::power(fr[m], fi[m]);
    }
    __syncthreads();
    for (int u = tid; u < TILE * n2; u += K4_THREADS) {
      const int c = u / n2, k2 = u - c * n2;
      const float* w = nat + rad + u;
      const float p = w[0];
      float mx = p;
      for (int d = -rad; d <= rad; ++d) mx = fmaxf(mx, w[d]);
      score[u] = rm_det::candidate(p, mx, k2 + n2 * (c0 + c), prm, conf_lin);
    }
    __syncthreads();
    // segment f = b2*n1 + k1: consecutive threads take consecutive k1
    for (int g = tid; g < TILE * (n2 / SEG); g += K4_THREADS) {
      const int b2 = g / TILE, c = g - b2 * TILE;
      const int f = b2 * n1 + c0 + c;
      rm_det::segment_partial(score + c * n2 + SEG * b2, 1, sc + f, sa + f);
    }
  }
  if constexpr (TOPK) {
    // ---- phase c: top-K over this row's partials (sc, sa: the scratch)
    __syncthreads();  // every partial of the row is written
    for (int f = tid; f < s; f += K4_THREADS) sbuf[f] = sc[f];
    __syncthreads();
    rm_det::block_topk<K4_THREADS>(sbuf, sa, s, topk, top_vals + row * rm_det::TOPK_LANES,
                                   top_packed + row * rm_det::TOPK_LANES);
  }
}

}  // namespace

// rmax may be null (kernel K4 emits no row max; K1's long rows take it).
// topk = 0: the partials to seg_score/seg_arg, top_vals/top_packed null;
// topk = K (1..128): seg_score/seg_arg are the scratch, and the [rows, 128]
// top-K block goes to top_vals/top_packed.
extern "C" int rm_detect_ct_partials(
    const float* fre, const float* fim, float* seg_score, float* seg_arg, float* nf, float* rmax,
    int rows, int n1, int n2, int radius, int keep_lo, int keep_hi,
    float thr_lin, int has_conf, float conf_cs, float off, int bisect_iters,
    int topk, float* top_vals, float* top_packed, cudaStream_t stream) {
  if (n1 % TILE != 0 || n2 % SEG != 0 || radius < 0 || radius > n2 || topk < 0 || topk > rm_det::TOPK_LANES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t sub = static_cast<size_t>(n1) * n2 / SEG;
  const size_t tile = 2 * static_cast<size_t>(TILE) * n2 + 2 * radius;
  const size_t smem = (sub > tile ? sub : tile) * sizeof(float);
  const auto kernel = topk > 0 ? detect_ct_kernel<true> : detect_ct_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const DetectParams prm{radius, keep_lo, keep_hi, thr_lin, has_conf, conf_cs, off, bisect_iters};
  kernel<<<rows, K4_THREADS, smem, stream>>>(fre, fim, seg_score, seg_arg, nf, rmax, n1, n2, prm, topk, top_vals,
                                             top_packed);
  return static_cast<int>(cudaGetLastError());
}
