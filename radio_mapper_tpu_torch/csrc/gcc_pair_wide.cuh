// The GCC pair body at the wide inner lengths n1 = 384, 640 and 896 (the
// mixed-radix splits nfft = n1*n2 of block_len 57344 and up): cross-power,
// whitening, four-step inverse transform of the lag-window rows only,
// |r|/n -- the same function as gcc_pair.cuh's pair_lag_window, which
// keeps n1 = 128 and 256. The body of kernels K2, K5 and K6 at these
// lengths (gcc_pair.cu), and so of kernel K8's long design, which launches
// K2 on the spectra its own K1 launch wrote earlier in the stream.
//
// Notation as gcc_pair.cuh: CT-order spectra, bin k = k2 + n2*k1 at
// m = k2*n1 + k1, R = whiten(X conj(Y)), E[k2][p] = inner inverse n1-point
// FFT of row k2, C[k2][p] = E[k2][p] * TW[k2][p], and the window rows
// z[q][p] = sum_k2 W2[q][k2] C[k2][p] at times t = q*n1 + p.
//
// Design (one kernel instantiated for each n1; 256 threads, 8 warps):
//
// * A tile of pairs a block. A K2 block takes two pairs of one channel
//   that share a receiver (wide_tiles in ops/cuda/gcc_pair.py: each
//   receiver in turn pairs off its pairs not yet taken, two at a time, so
//   the 28 pairs of 8 receivers make 14 tiles of two); K5 and K6 take one
//   pair a block. The tile's sources -- the shared receiver in slot 0, each
//   pair's other receiver in slot g + 1 -- are staged in shared memory a
//   chunk of `rows` CT rows at a time, so a receiver read by both pairs is
//   read once. When the window needs more than one 8-column n-tile (see
//   the fold), K2 takes one pair a block.
// * Bulk copies, double-buffered. Warp 0 issues one cp.async.bulk (TMA,
//   1-D) a source and plane, each completing on the buffer's mbarrier
//   (expect_tx), one chunk ahead: chunk k + 1 is in flight while chunk k
//   is transformed and folded. A chunk's rows are contiguous in a plane,
//   so one copy takes all of them. The warps read their points from
//   shared memory, not from L2; the copies are plain global reads, so
//   spectra that an earlier launch of the stream wrote (K8's long design)
//   are read as they are.
// * The inner FFT, one warp a (pair, row) job: lane l takes bins
//   k1 = l + 32*i (i < P = n1/32 = 4q) of X and Y, forms the whitened R
//   (gcc_pair.cuh's gate) and runs a mixed-radix DIF warp FFT: two
//   radix-2 stages and the direct q-point DFTs (q = 3, 5, 7) in
//   registers, then the five shuffle stages of gcc_pair.cuh's radix-2
//   body. Its P - 1 register-stage twiddles a lane and the q roots are
//   read from a table in shared memory loaded once a block; only the
//   shuffle twiddles stay in registers (the last is 1 and is not
//   applied). Point i of lane l holds time p = P*brev5(l) + digit(i);
//   C = E * TW is stored over the pair's own slot-(g + 1) row, which no
//   other job reads, at swz_wide(p, row), a permutation of the row by
//   XORs of low bits: the stores of a warp and the fold's reads are free
//   of bank conflicts. TW[k2][p] = W_n^(k2 p) is not read from the
//   [n2][n1] table (as many bytes again as a spectrum, a pair): a lane
//   forms W_n^(k2 p0) and W_n^k2 from two small tables in shared memory
//   (W_n^(256a), W_n^b) and steps through its P times by products.
// * The fold on tensor cores, its B read from the block's window rows of
//   W2, staged in shared memory once. Per pair it is a real product
//   Z^T[p][(q, re|im)] = [C_re C_im][p][(k2, re|im)] * B, with
//   B[(k2, re)][(q, re)] = Re W2, B[(k2, im)][(q, re)] = -Im W2,
//   B[(k2, re)][(q, im)] = Im W2, B[(k2, im)][(q, im)] = Re W2: M = n1,
//   N = 2*(nneg + npos) padded to n-tiles of 8, K = 2 * rows a chunk.
//   mma.sync.m16n8k8 TF32 in the 3xTF32 split (x = big + small, big its
//   top 19 bits by a mask, small = x - big, both read as TF32;
//   small*big + big*small + big*big accumulated in FP32) keeps FP32
//   accuracy: tau is unchanged, the windows stay within 1e-4 of their max
//   of the plain FP32 version, with the same argmax. Warp w owns m-tiles
//   w*n1/128 .. (w + 1)*n1/128 - 1 of each of its two accumulator slots
//   (a (pair, n-tile) each), held in registers across all chunks;
//   blockIdx.y takes further n-tiles where a window has more. Each lane
//   then holds Re and Im of z at two (q, p) and writes |z|/n where that
//   time is in the window.
//
// Registers, spills and resident blocks a length (256 threads,
// __launch_bounds__ MIN_BLOCKS; rm_gcc_pair_wide_info reports them on the
// card, chip_smoke.py phase 20 prints them; NVIDIA H100, max_lag 600):
//   n1 = 384: 128 registers, no spills, 2 blocks an SM (K2 85 KB of shared
//             memory, K5/K6 110 KB)
//   n1 = 640: K2 216, K5/K6 182 registers, no spills, 1 block (137/178 KB)
//   n1 = 896: 255 registers, no spills, 1 block (189/132 KB)
// At 640 and 896 the register stage's P = 20, 28 points, the TW chain
// and two slots of MT = 5, 7 m-tiles' accumulators do not fit 128
// registers; their twiddles are in shared memory as at 384.
//
// Bound on the H100: a pair reads its two spectra (one and a half where a
// receiver is shared), n*8 bytes each, from L2 (a channel's spectra stay
// there while its tiles run); the inner FFT is 5*n*log2(n1) FLOP a pair,
// the fold 8*n*(nneg + npos) on the tensor cores (x3 for the split).
// tests/test_torch_pair_wide.py replays the fragment map, the split, the
// tile cover and the shared-memory layout in numpy.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "ct_dft.cuh"
#include "ct_fft.cuh"
#include "gcc_pair.cuh"

namespace rm_wide {

constexpr int THREADS = 256;  // gcc_pair.THREADS
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SRC = 3;    // a centre and two leaves
constexpr int MAX_PAIRS = 2;
constexpr int SLOTS = 2;      // accumulator (pair, n-tile) slots a warp
constexpr int TW_LO = 256;    // the inverse twiddle W_n^e = hi[e / 256] * lo[e % 256]

// __launch_bounds__' minimum blocks an SM: two at n1 = 384 (at most 128
// registers a thread), one at 640 and 896
template <int N1>
constexpr int MIN_BLOCKS = N1 == 384 ? 2 : 1;

// ---- PTX wrappers: mbarrier, bulk copy, proxy fence, TF32 mma ----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from global src to shared dst (both 16-byte
// aligned), completing on bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// orders this thread's generic accesses to shared memory before later
// async-proxy (bulk copy) writes to it
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// x = big + small: big keeps the sign, exponent and top 10 mantissa bits
// (a TF32 value), small = x - big exactly; the tensor cores read small's
// top 19 bits (TF32). Masks and a subtraction, no conversions.
__device__ __forceinline__ float tf32_big(float x) { return __uint_as_float(__float_as_uint(x) & 0xffffe000u); }

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  const float b = tf32_big(x);
  big = __float_as_uint(b);
  small = __float_as_uint(x - b);
}

// d += a * b, m16n8k8, A row-major 16x8, B column-major 8x8, TF32 in, FP32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the warp FFT with its register-stage twiddles in shared memory ----

// Slot j < P - 1 of lane l's register-stage twiddles (P = 4q; W = W_N1,
// read from wi = W^-e, e < N1/2): W^-(l + 32j) for j < 2q (stage
// h = N1/2), W^-(2(l + 32(j - 2q))) for j < 3q (h = N1/4), then
// W^-(4*l*u) for the q-point DFTs' output u = j - 3q + 1. Every exponent
// depends on the lane and j, never on the row.
template <int N1>
__device__ __forceinline__ float2 reg_twiddle(const float2* __restrict__ wi, int j, int lane) {
  constexpr int Q = N1 / 128;
  if (j < 2 * Q) return __ldg(wi + lane + 32 * j);
  if (j < 3 * Q) return __ldg(wi + 2 * (lane + 32 * (j - 2 * Q)));
  const int e = (4 * lane * (j - 3 * Q + 1)) % N1;  // W^-e = -W^-(e - N1/2) above N1/2
  const float2 w = __ldg(wi + (e < N1 / 2 ? e : e - N1 / 2));
  return e < N1 / 2 ? w : make_float2(-w.x, -w.y);
}

// Shared-memory twiddle table: [P - 1][32] per-lane register twiddles, then
// the q roots wq[Q] (the same for every lane).
template <int N1>
constexpr int twiddle_floats() {
  return 2 * ((N1 / 32 - 1) * 32 + N1 / 128);
}

// The inverse N1-point FFT of one row held by a warp, point i of lane l at
// k1 = l + 32*i, P = N1/32 = 4q: the radix-2 stages h = N1/2 and N1/4 in
// registers (points i, i + 2q; then i, i + q), the direct q-point DFT of
// each block of q points (ct_fft.cuh q_dfts) times W^-(4*l*u), then the
// shuffle stages h = 16 .. 1. Register twiddle j of lane l is
// twt[32*j + l], the q roots twt[32*(P - 1) + u]. Point i of lane l then
// holds E[P*brev5(l) + digit<P>(i)] (ct_fft.cuh).
template <int N1>
__device__ __forceinline__ void inverse_row_fft_wide(float2 (&v)[N1 / 32], const float2* twt, const float2 (&tl)[5],
                                                     int lane) {
  constexpr int P = N1 / 32;
  constexpr int Q = P / 4;
  const float2* tr = twt + lane;
#pragma unroll
  for (int g = 2 * Q; g >= Q; g -= Q) {  // the stages h = N1/2 and N1/4
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i % (2 * g) >= g) continue;
      const float2 a = v[i], b = v[i + g];
      v[i] = rm_fft::cadd(a, b);
      v[i + g] = rm_ct::cmul(rm_fft::csub(a, b), tr[32 * ((g == 2 * Q ? 0 : 2 * Q) + i % g)]);
    }
  }
  float2 wq[Q];
#pragma unroll
  for (int u = 0; u < Q; ++u) wq[u] = twt[32 * (P - 1) + u];
  rm_fft::q_dfts<P>(v, wq);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int u = 1; u < Q; ++u) v[b * Q + u] = rm_ct::cmul(v[b * Q + u], tr[32 * (3 * Q + u - 1)]);
  }
  // lane bit h clear: v + w (times 1); set: (w - v) * W, with no select;
  // the last stage's W is 1 for every lane (multiplying by it is exact)
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int h = 16 >> s;
    const float sg = (lane & h) ? -1.f : 1.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float2 w = make_float2(__shfl_xor_sync(0xffffffffu, v[i].x, h),
                                   __shfl_xor_sync(0xffffffffu, v[i].y, h));
      const float2 d = make_float2(fmaf(sg, v[i].x, w.x), fmaf(sg, v[i].y, w.y));
      v[i] = s < 4 ? rm_ct::cmul(d, tl[s]) : d;
    }
  }
}

// Where time p of C row rr sits in its row: p with its two low bits XOR
// (p / 8P) mod 4, then bits 3..4 XOR rr mod 4 (a permutation of the row,
// n1 a multiple of 32). A warp's store of times P*b + d (b = brev5(l),
// fixed d) hits 32 banks (P*b mod 32 = 4*((P/4)*b mod 8), and the two low
// bits take b/8 = p/(8P)), and so do the fold's reads of 8 times from four
// rows (the rows' bits 3..4).
template <int P>
__device__ __forceinline__ int swz_wide(int p, int rr) {
  return (p ^ ((p / (8 * P)) & 3)) ^ ((rr & 3) << 3);
}

// ---- the tile, as the kernels hand it to the body ----------------------

// Written by thread 0 before the body's first barrier: the sources' rows
// (re and im planes, CT order), and per pair g its X and Y source slots
// (the leaf is slot g + 1), l2rx floor eps^2 * s2 and window row.
struct Tile {
  const float* src[2 * MAX_SRC];  // re of slot s at [2s], im at [2s + 1]
  float* out[MAX_PAIRS];
  float floor2[MAX_PAIRS];
  float l1_floor[MAX_PAIRS];
  int xs[MAX_PAIRS], ys[MAX_PAIRS];
  int nsrc, npairs;
};

// Stage chunk k (rows k*rows .. + rows - 1, fewer at the end) of every
// source into buf: warp 0 only.
template <int N1>
__device__ __forceinline__ void stage_chunk(const Tile& t, float* buf, uint64_t* bar, int k, int rows, int n2,
                                            int lane) {
  const int r0 = k * rows;
  const int have = min(rows, n2 - r0);  // the chunk's rows are contiguous in a plane
  const int ncopy = t.nsrc * 2;         // one copy a source and plane (sp = 2*source + plane)
  if (lane == 0) mbar_expect_tx(bar, static_cast<uint32_t>(ncopy * have) * N1 * 4);
  __syncwarp();
  if (lane < ncopy) bulk_copy(buf + lane * rows * N1, t.src[lane] + static_cast<size_t>(r0) * N1, have * N1 * 4, bar);
}

// The l2 / l1 gates' scale: the pair's max |R|^2 (l2) or max |R| (l1) over
// its n bins, read from global memory; every thread gets it.
__device__ __forceinline__ float pair_scale(const float* xr, const float* xi, const float* yr, const float* yi,
                                            int n, int gate, float* red) {
  const int tid = threadIdx.x;
  float v = 0.f;  // |R|^2 and mag are >= 0
  for (int m = tid; m < n; m += THREADS) {
    float rr, ri;
    rm_pair::cross(__ldg(xr + m), __ldg(xi + m), __ldg(yr + m), __ldg(yi + m), rr, ri);
    const float p2 = __fadd_rn(__fmul_rn(rr, rr), __fmul_rn(ri, ri));
    v = fmaxf(v, gate == rm_pair::GATE_L2 ? p2 : __fmul_rn(p2, rsqrtf(__fadd_rn(p2, 1e-30f))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < WARPS; ++w) s = fmaxf(s, red[w]);
  __syncthreads();  // red is written again by the next pair
  return s;
}

// Dynamic shared memory of the body, in floats: two buffers of nsrc
// sources x 2 planes x rows rows at the pitch; the block's window rows of
// W2, ntg*4 rows of n2; the warp FFT's twiddle table; the inverse
// twiddle's two factors, ceil(n/256) + 256 values.
template <int N1>
__host__ __device__ constexpr int buffer_floats(int nsrc, int rows) {
  return nsrc * 2 * rows * N1;
}

__host__ __device__ constexpr int tw_hi_count(int n) { return (n + TW_LO - 1) / TW_LO; }

__host__ __device__ inline size_t smem_floats(int n1, int n2, int nsrc, int rows, int ntg) {
  return 2 * static_cast<size_t>(nsrc) * 2 * rows * n1 + 2 * ((n1 / 32 - 1) * 32 + n1 / 128) +
         2 * static_cast<size_t>(ntg) * 4 * n2 + 2 * static_cast<size_t>(tw_hi_count(n1 * n2) + TW_LO);
}

// One tile (t.npairs pairs on t.nsrc sources). sm: the dynamic shared
// memory (smem_floats), 16-byte aligned. ntg: n-tiles a pair in this block
// (slots / pairs at most), cg = blockIdx.y its group: n-tiles cg*ntg ..
// (cg + 1)*ntg - 1 of the window's nt = ceil((nneg + npos) / 4). twx: the
// inverse twiddle's factors W_n^(256a) (a < ceil(n/256)), then W_n^b
// (b < 256).
template <int N1>
__device__ __forceinline__ void wide_pair_body(
    Tile& t, int gate, float eps2, float eps, const float2* __restrict__ wi, const float2* __restrict__ w2,
    const float2* __restrict__ twx, float* sm, int max_src, int n2, int nneg, int npos, int max_lag,
    float inv_n, int rows, int ntg) {
  constexpr int P = N1 / 32;
  constexpr int MT = N1 / 16 / WARPS;  // m-tiles a warp
  __shared__ uint64_t bars[2];
  __shared__ float red[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int nw = nneg + npos;
  const int nt = (nw + 3) / 4;
  const int bstride = buffer_floats<N1>(max_src, rows);
  float* buf0 = sm;
  float2* w2s = reinterpret_cast<float2*>(sm + 2 * bstride);  // [ntg*4][n2]: window rows of W2
  float2* twt = w2s + ntg * 4 * n2;                              // the warp FFT's twiddles
  float2* twh = twt + (P - 1) * 32 + N1 / 128;                   // inverse twiddle factors: hi, then lo
  const int nh = tw_hi_count(N1 * n2);
  const float2* twl = twh + nh;
  const int cg = blockIdx.y;
  const int nchunks = (n2 + rows - 1) / rows;

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < (P - 1) * 32; i += THREADS) twt[i] = reg_twiddle<N1>(wi, i >> 5, i & 31);
  if (tid < N1 / 128) {  // rm_fft::q_roots: W_q^u, the conjugate of W_q^(q - u) above q/2
    constexpr int Q = N1 / 128;
    const int u = tid <= Q / 2 ? tid : Q - tid;
    const float2 w = u == 0 ? make_float2(1.f, 0.f) : wi[u * (N1 / Q)];
    twt[(P - 1) * 32 + tid] = tid <= Q / 2 ? w : make_float2(w.x, -w.y);
  }
  for (int i = tid; i < ntg * 4 * n2; i += THREADS) {  // zero past the window's last row
    const int qw = cg * ntg * 4 + i / n2, k2 = i % n2;
    const int q = qw < nneg ? n2 - nneg + qw : qw - nneg;
    w2s[i] = qw < nw ? __ldg(w2 + static_cast<size_t>(q) * n2 + k2) : make_float2(0.f, 0.f);
  }
  for (int i = tid; i < nh + TW_LO; i += THREADS) twh[i] = __ldg(twx + i);
  __syncthreads();  // barriers, tables and the tile visible

  if (warp == 0) {
    stage_chunk<N1>(t, buf0, &bars[0], 0, rows, n2, lane);
    if (nchunks > 1) stage_chunk<N1>(t, buf0 + bstride, &bars[1], 1, rows, n2, lane);
  }

  // l2 / l1: each pair's scale, while the first chunks arrive
  if (gate == rm_pair::GATE_L2 || gate == rm_pair::GATE_L1) {
    const int n = N1 * n2;
    for (int g = 0; g < t.npairs; ++g) {
      const float s = pair_scale(t.src[2 * t.xs[g]], t.src[2 * t.xs[g] + 1], t.src[2 * t.ys[g]],
                                 t.src[2 * t.ys[g] + 1], n, gate, red);
      if (tid == 0) {
        if (gate == rm_pair::GATE_L2) t.floor2[g] = __fmul_rn(eps2, s);
        t.l1_floor[g] = __fmul_rn(eps, s);
      }
    }
    __syncthreads();
  }

  float2 tl[5];  // the shuffle stages' twiddles (RowTwiddles::lane)
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int h = 16 >> s;
    tl[s] = (lane & h) ? __ldg(wi + (lane & (h - 1)) * (N1 / 2 / h)) : make_float2(1.f, 0.f);
  }
  const int p0 = P * static_cast<int>(__brev(lane) >> 27);  // this lane's first time p

  float acc[SLOTS][MT][4];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;
    }
  }
  // slot j: pair j / ntg, n-tile cg*ntg + j % ntg (the same for the whole block)
  bool live[SLOTS];
  int aslot[SLOTS], brow[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int g = j / ntg;
    live[j] = g < t.npairs && cg * ntg + j % ntg < nt;
    aslot[j] = (g + 1) * 2 * rows * N1;                // the pair's leaf: its C rows
    brow[j] = ((j % ntg) * 4 + (gid >> 1)) * n2;       // B column gid's row of w2s
  }
  const int kb = static_cast<int>(__brev(lane) >> 30);  // swz_wide(p0 + d, rr) = (p0 + (d ^ kb)) ^ 8*(rr & 3)

  for (int k = 0; k < nchunks; ++k) {
    float* buf = buf0 + (k & 1) * bstride;
    const int r0 = k * rows;
    mbar_wait(&bars[k & 1], (k >> 1) & 1);

    // the inner FFT: job (g, rr) = pair g, chunk row rr, one a warp
    for (int job = warp; job < t.npairs * rows; job += WARPS) {
      const int g = job / rows, rr = job - g * rows;
      const int k2 = r0 + rr;
      float* cre = buf + ((g + 1) * 2 * rows + rr) * N1;  // the leaf's row: C goes here
      float* cim = cre + rows * N1;
      if (k2 < n2) {
        const float* xre = buf + (t.xs[g] * 2 * rows + rr) * N1;
        const float* yre = buf + (t.ys[g] * 2 * rows + rr) * N1;
        const float* xim = xre + rows * N1;
        const float* yim = yre + rows * N1;
        const float floor2 = t.floor2[g], l1_floor = t.l1_floor[g];
        float2 v[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const int k1 = lane + 32 * i;
          float rr_, ri_;
          rm_pair::cross(xre[k1], xim[k1], yre[k1], yim[k1], rr_, ri_);
          v[i] = rm_pair::whiten(rr_, ri_, gate, floor2, l1_floor);
        }
        inverse_row_fft_wide<N1>(v, twt, tl, lane);
        __syncwarp();  // every lane's reads of the leaf's row are done
        // TW[k2][p0 + d] = W_n^(k2*p0) * (W_n^k2)^d (k2*p < n): two table
        // factors each, then a product a time
        const int e0 = k2 * p0;
        float2 w = rm_ct::cmul(twh[e0 / TW_LO], twl[e0 % TW_LO]);
        const float2 step = rm_ct::cmul(twh[k2 / TW_LO], twl[k2 % TW_LO]);
#pragma unroll
        for (int d = 0; d < P; ++d) {
          const float2 c = rm_ct::cmul(v[rm_fft::digit_inv<P>(d)], w);
          const int o = (p0 + (d ^ kb)) ^ ((rr & 3) << 3);  // swz_wide<P>(p0 + d, rr)
          cre[o] = c.x;
          cim[o] = c.y;
          w = rm_ct::cmul(w, step);
        }
      } else {  // past the last row: C = 0
        for (int i = lane; i < N1; i += 32) {
          cre[i] = 0.f;
          cim[i] = 0.f;
        }
      }
    }
    __syncthreads();

    // the fold: one k-step of 4 rows (K = 8) at a time
    for (int ks = 0; ks < rows / 4; ++ks) {
      const int ra = ks * 4 + tig;  // this lane's chunk row in A and B
      const int k2 = r0 + ra;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        if (!live[j]) continue;
        // B column gid: window row ntile*4 + gid/2, re (gid even) or im
        const float2 w = k2 < n2 ? w2s[brow[j] + k2] : make_float2(0.f, 0.f);
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32((gid & 1) ? w.y : w.x, bb0, bs0);
        split_tf32((gid & 1) ? w.x : -w.y, bb1, bs1);
        const float* are = buf + aslot[j] + ra * N1;
        const float* aim = are + rows * N1;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int pt = (warp * MT + i) * 16;
          const int lo = gid ^ ((pt / (8 * P)) & 3);  // swz_wide<P>(pt + gid (+ 8), ra): ra & 3 = tig
          const int o0 = (pt ^ (tig << 3)) + lo, o1 = ((pt + 8) ^ (tig << 3)) + lo;
          uint32_t ab[4], as[4];
          split_tf32(are[o0], ab[0], as[0]);
          split_tf32(are[o1], ab[1], as[1]);
          split_tf32(aim[o0], ab[2], as[2]);
          split_tf32(aim[o1], ab[3], as[3]);
          mma_tf32(acc[j][i], as, bb0, bb1);
          mma_tf32(acc[j][i], ab, bs0, bs1);
          mma_tf32(acc[j][i], ab, bb0, bb1);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();  // buf is free: the copies of chunk k + 2 may land
    if (warp == 0 && k + 2 < nchunks) stage_chunk<N1>(t, buf, &bars[k & 1], k + 2, rows, n2, lane);
  }

  // lags -L..-1 are the last L times of the neg rows, 0..L the first L + 1
  // of the pos rows: flat index qw*n1 + p - (nneg*n1 - L)
  const int width = 2 * max_lag + 1;
  const int base = nneg * N1 - max_lag;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    if (!live[j]) continue;
    const int g = j / ntg;
    const int qw = (cg * ntg + j % ntg) * 4 + tig;
    if (qw >= nw) continue;
    float* orow = t.out[g];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (warp * MT + i) * 16 + gid + 8 * h;
        const int f = qw * N1 + p - base;
        const float x = acc[j][i][2 * h], y = acc[j][i][2 * h + 1];
        if (f >= 0 && f < width) orow[f] = __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y))), inv_n);
      }
    }
  }
}

}  // namespace rm_wide
