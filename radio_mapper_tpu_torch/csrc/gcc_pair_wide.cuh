// The GCC pair body at every inner length n1 = 128, 256, 384, 640, 896 of
// the CT split nfft = n1*n2: cross-power, whitening, four-step inverse
// transform of the lag-window rows only, |r|/n. The body of kernels K2, K5
// and K6 (gcc_pair.cu, one kernel a length and kind) and of kernel K8's
// pair half (channel_step.cu, n1 = 128, 512 threads; K8's long design
// launches K2 on the spectra its own K1 launch wrote earlier in the
// stream).
//
// CT-order spectra: bin k = k2 + n2*k1 at m = k2*n1 + k1. The inverse
// consumes that order and emits time t = q*n1 + p:
//   R[k2][k1] = whiten(X * conj(Y))                (gcc_pair.cuh)
//   E[k2][p]  = sum_k1 R[k2][k1] W_n1^(-k1 p)      (inner inverse n1-point FFT)
//   C[k2][p]  = E[k2][p] * TW[k2][p],  TW = W_n^(k2 p)
//   z[q][p]   = sum_k2 W2[q][k2] C[k2][p]          (outer, window rows q only)
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
//   read once. When the tile's windows need more n-tiles (see the fold)
//   than a block has accumulator slots, K2 takes one pair a block.
// * Bulk copies, double-buffered. Warp 0 issues one cp.async.bulk (TMA,
//   1-D) a source and plane, each completing on the buffer's mbarrier
//   (expect_tx), one chunk ahead: chunk k + 1 is in flight while chunk k
//   is transformed and folded. A chunk's rows are contiguous in a plane,
//   so one copy takes all of them; wide_plan sizes a chunk (CHUNK_ROWS: at
//   n1 = 128 16 rows for one pair, 8 for two, 4 for K5's tiles of six; 8
//   at 256; 8 and 4 above). The warps read their points from shared memory, not from
//   L2. The copies are async-proxy reads: the body fences the proxies
//   before the first copy, so spectra that other blocks of the same
//   launch wrote before a cluster barrier (kernel K8) are read as written.
// * The inner FFT, one warp a (pair, row) job: lane l takes bins
//   k1 = l + 32*i (i < P = n1/32) of X and Y, forms the whitened R and
//   runs a DIF warp FFT: in registers, the radix-2 stages h = n1/2 .. 32
//   (P = 4, 8) or two radix-2 stages and the direct q-point DFTs (P = 4q,
//   q = 3, 5, 7), then five radix-2 stages across lanes by
//   __shfl_xor_sync. Its P - 1 register-stage twiddles a lane (and the q
//   roots) are read from a table in shared memory loaded once a block;
//   only the shuffle twiddles stay in registers (the last is 1 and is not
//   applied). Point i of lane l holds time p = P*brev5(l) + digit(i);
//   C = E * TW is stored over the pair's own slot-(g + 1) row, which no
//   other job reads, at swz_wide(p, row), a permutation of the row by
//   XORs of low bits: the stores of a warp and the fold's reads are free
//   of bank conflicts. TW[k2][p] = W_n^(k2 p) is not read from a
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
//   small*big + big*small + big*big summed on the tensor cores from zero
//   each k-step, that sum added to the accumulator in FP32: a whole
//   window's sum on the tensor cores drifts, to 1.05e-6 of the window max
//   on the noise windows of the sharded step's nfft 2048, where one
//   window's top two lags lie closer and its argmax flipped) keeps FP32
//   accuracy: tau is unchanged, the windows stay within 1e-4 of their max
//   of the plain FP32 version, with the same argmax. A block holds
//   SLOTS<n1> accumulator slots, a (pair, n-tile) each (6 at n1 = 128, 4
//   at 256, 2 above: 24 or 32 registers a thread); warp w owns m-tiles
//   w*n1/128 .. (w + 1)*n1/128 - 1 of every slot, held in registers
//   across all chunks (a block of 512 threads, K8's, splits the slots
//   between its two halves of 8 warps instead). blockIdx.y (K8: a loop)
//   takes further n-tiles where a window has more. Each lane then holds
//   Re and Im of z at two (q, p) and writes |z|/n where that time is in
//   the window.
// * The fold adds one k-step of 4 rows at a time, k2 = 4s .. 4s + 3 in
//   ascending s, whatever a chunk's rows, a tile's pairs or the block's
//   threads (chunks start at multiples of 4 rows; k-steps wholly past n2
//   are skipped): every kernel forms a pair's window by the same mma
//   sequence, so K8's windows equal K1 -> K2's bit for bit.
//
// Registers, spills and resident blocks a length (256 threads,
// __launch_bounds__ MIN_BLOCKS; rm_gcc_pair_info reports them on the
// card, chip_smoke.py phases 3 and 20 print them; PERF.md holds the
// numbers of the last card run).
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

constexpr int THREADS = 256;  // gcc_pair.THREADS: K2, K5, K6 (K8 runs the body at 512)
constexpr int MAX_PAIRS = 6;  // a tile's pairs: K2 and K8 take 2, K5 up to SLOTS / n-tiles
constexpr int MAX_SRC = MAX_PAIRS + 1;  // a centre and a leaf a pair
constexpr int TILE_INTS = MAX_SRC + 1 + 2 * MAX_PAIRS;  // a row of gcc_pair.wide_tiles
constexpr int TW_LO = 256;    // the inverse twiddle W_n^e = hi[e / 256] * lo[e % 256]

// accumulator (pair, n-tile) slots a block (gcc_pair.WIDE_SLOTS): a
// 256-thread block's warp holds n1/128 m-tiles of each, 4 floats a tile
template <int N1>
constexpr int SLOTS = N1 == 128 ? 6 : N1 == 256 ? 4 : 2;

// __launch_bounds__' minimum blocks an SM: three at n1 = 128 (at most 80
// registers a thread, no spills; K5's short tiles need the third block to
// hide their latency), two at 256 and 384 (at most 128), one at 640 and 896
template <int N1>
constexpr int MIN_BLOCKS = N1 == 128 ? 3 : N1 <= 384 ? 2 : 1;

// How NT threads share the fold's m-tiles and slots: WARPS warps, SG slot
// groups (2 where there are more warps than the n1/16 m-tiles, else 1),
// MT m-tiles and SW slots a warp.
template <int N1, int NT>
struct Layout {
  static constexpr int WARPS = NT / 32;
  static constexpr int MTILES = N1 / 16;
  static constexpr int SG = WARPS > MTILES ? WARPS / MTILES : 1;
  static constexpr int MT = MTILES * SG / WARPS;
  static constexpr int SW = SLOTS<N1> / SG;
  static_assert(MT >= 1 && MT * WARPS == MTILES * SG && SW * SG == SLOTS<N1>, "the fold's warps");
};

// ---- PTX wrappers: mbarrier, bulk copy, proxy fence, TF32 mma ----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
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

// the same for global memory: generic writes (of this thread, or made
// visible to it by a barrier) before later async-proxy reads
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

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

// Slot j < P - 1 of lane l's register-stage twiddles (W = W_N1, read from
// wi = W^-e, e < N1/2). P = 4, 8: slot P - h/16 + u of the stage of
// half-size h (h = N1/2 .. 32, u < h/32) is W^-((l + 32u)*N1/(2h)). P = 4q,
// q odd: W^-(l + 32j) for j < 2q (stage h = N1/2), W^-(2(l + 32(j - 2q)))
// for j < 3q (h = N1/4), then W^-(4*l*u) for the q-point DFTs' output
// u = j - 3q + 1. Every exponent depends on the lane and j, never on the row.
template <int N1>
__device__ __forceinline__ float2 reg_twiddle(const float2* __restrict__ wi, int j, int lane) {
  if constexpr (rm_fft::is_pow2(N1 / 32)) {
    int h = N1 / 2, base = 0;
    while (j >= base + h / 32) {
      base += h / 32;
      h >>= 1;
    }
    return __ldg(wi + (lane + 32 * (j - base)) * (N1 / 2 / h));
  } else {
    constexpr int Q = N1 / 128;
    if (j < 2 * Q) return __ldg(wi + lane + 32 * j);
    if (j < 3 * Q) return __ldg(wi + 2 * (lane + 32 * (j - 2 * Q)));
    const int e = (4 * lane * (j - 3 * Q + 1)) % N1;  // W^-e = -W^-(e - N1/2) above N1/2
    const float2 w = __ldg(wi + (e < N1 / 2 ? e : e - N1 / 2));
    return e < N1 / 2 ? w : make_float2(-w.x, -w.y);
  }
}

// Shared-memory twiddle table, in float2: [P - 1][32] per-lane register
// twiddles, then (P = 4q, q odd) the q roots wq[q], the same for every
// lane, then [4][32] the shuffle stages' twiddles a lane (the fifth stage's
// is 1): W^-((l mod h)*N1/(2h)) where lane bit h is set, else 1.
__host__ __device__ constexpr int shuffle_base(int n1) {
  return (n1 / 32 - 1) * 32 + (rm_fft::is_pow2(n1 / 32) ? 0 : n1 / 128);
}

__host__ __device__ constexpr int twiddle_count(int n1) { return shuffle_base(n1) + 4 * 32; }

// The inverse N1-point FFT of one row held by a warp, point i of lane l at
// k1 = l + 32*i: the register stages (P = 4, 8: radix-2, h = N1/2 .. 32,
// points i and i + h/32; P = 4q: the radix-2 stages h = N1/2 and N1/4,
// points i, i + 2q, then i, i + q, and the direct q-point DFT of each
// block of q points, ct_fft.cuh q_dfts, times W^-(4*l*u)), then the
// shuffle stages h = 16 .. 1. Register twiddle j of lane l is
// twt[32*j + l], the q roots twt[32*(P - 1) + u], shuffle stage s's
// twt[shuffle_base + 32*s + l]. Point i of lane l then holds
// E[P*brev5(l) + digit<P>(i)] (ct_fft.cuh).
template <int N1>
__device__ __forceinline__ void inverse_row_fft_wide(float2 (&v)[N1 / 32], const float2* twt, int lane) {
  constexpr int P = N1 / 32;
  const float2* tr = twt + lane;
  const float2* ts = twt + shuffle_base(N1) + lane;
  if constexpr (rm_fft::is_pow2(P)) {
#pragma unroll
    for (int s = 0; s < rm_fft::log2_of(P); ++s) {  // h = N1/2 >> s = 32*g
      const int g = (P / 2) >> s;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (i & g) continue;
        const float2 a = v[i], b = v[i + g];
        v[i] = rm_fft::cadd(a, b);
        v[i + g] = rm_ct::cmul(rm_fft::csub(a, b), tr[32 * (P - 2 * g + (i & (g - 1)))]);
      }
    }
  } else {
    constexpr int Q = P / 4;
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
      v[i] = s < 4 ? rm_ct::cmul(d, ts[32 * s]) : d;
    }
  }
}

// The low bits of time p that swz_wide XORs: (p / 8P) mod 4, except at
// P = 8, where 8P would leave a bit of P*brev5(l) out: (p / 32) mod 8.
template <int P>
__host__ __device__ constexpr int swz_lo(int p) {
  return P == 8 ? (p >> 5) & 7 : (p / (8 * P)) & 3;
}

// Where time p of C row rr sits in its row: p with its low bits XOR
// swz_lo(p), then bits 3..4 XOR rr mod 4 (a permutation of the row, n1 a
// multiple of 32). A warp's store of times P*b + d (b = brev5(l), fixed d)
// hits 32 banks: P*b mod 32 takes 8 values 4 apart (P = 4, 12, 20, 28) or
// 4 values 8 apart (P = 8), and the low bits take the rest of b
// (swz_lo); so do the fold's reads of 8 times from four rows (the rows'
// bits 3..4).
template <int P>
__device__ __forceinline__ int swz_wide(int p, int rr) {
  return (p ^ swz_lo<P>(p)) ^ ((rr & 3) << 3);
}

// A lane's C = E * TW at its times p0 + D, D = 0 .. P - 1, from register
// digit_inv(D) (a constant: a register index the compiler could not fold
// would put v in local memory), TW stepped by one product a time, stored
// at swz_wide(p0 + D, row) = (p0 + (D ^ kb)) ^ rx.
template <int P, int D = 0>
__device__ __forceinline__ void store_c(const float2 (&v)[P], float2 w, float2 step, float* cre, float* cim,
                                        int p0, int kb, int rx) {
  if constexpr (D < P) {
    constexpr int I = rm_fft::digit_inv<P>(D);
    const float2 c = rm_ct::cmul(v[I], w);
    const int o = (p0 + (D ^ kb)) ^ rx;
    cre[o] = c.x;
    cim[o] = c.y;
    store_c<P, D + 1>(v, rm_ct::cmul(w, step), step, cre, cim, p0, kb, rx);
  }
}

// A lane's A fragment of m-tile rows pt .. pt + 15 (C times, swizzled) from
// the k-step's chunk row ra (ra & 3 = tig; are/aim: that row's re and im),
// split: (pt + gid, ra), (pt + 8 + gid, ra) of re, then of im.
template <int P>
__device__ __forceinline__ void a_fragment(const float* are, const float* aim, int pt, int gid, int tig,
                                           uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const int lo = gid ^ swz_lo<P>(pt);  // swz_wide<P>(pt + gid (+ 8), ra)
  const int o0 = (pt ^ (tig << 3)) + lo, o1 = ((pt + 8) ^ (tig << 3)) + lo;
  split_tf32(are[o0], ab[0], as[0]);
  split_tf32(are[o1], ab[1], as[1]);
  split_tf32(aim[o0], ab[2], as[2]);
  split_tf32(aim[o1], ab[3], as[3]);
}

// What a warp folds of a chunk: its pairs g0 .. g0 + NP - 1 (their C rows
// in slots g0 + 1 ..), n-tiles nj0 .. nj0 + NTL - 1 of the block's window
// rows of W2 in w2s, into accumulator slots gp*NTL + u.
struct FoldArgs {
  const float* buf;
  const float2* w2s;
  int krows, rows, r0, n2, g0, nj0, mw, gid, tig;
};

// One chunk's k-steps of 4 rows (K = 8), in order: per k-step the NTL B
// fragments of the n-tiles, shared by the NP pairs, then per pair and
// m-tile its A fragment, shared by its n-tiles; per accumulator the three
// products of the split, always in the same order. No branch between the
// products, so the scheduler interleaves the independent accumulators.
template <int P, int MT, int SW, int NP, int NTL>
__device__ __forceinline__ void fold_chunk(float (&acc)[SW][MT][4], const FoldArgs& f) {
  constexpr int N1 = 32 * P;
  for (int ks = 0; ks < f.krows / 4; ++ks) {
    const int ra = ks * 4 + f.tig;  // this lane's chunk row in A and B
    const int k2 = f.r0 + ra;
    uint32_t b[NTL][4];  // B column gid: window row ntile*4 + gid/2, re (gid even) or im: bb0, bs0, bb1, bs1
#pragma unroll
    for (int u = 0; u < NTL; ++u) {
      const float2 w = k2 < f.n2 ? f.w2s[((f.nj0 + u) * 4 + (f.gid >> 1)) * f.n2 + k2] : make_float2(0.f, 0.f);
      split_tf32((f.gid & 1) ? w.y : w.x, b[u][0], b[u][1]);
      split_tf32((f.gid & 1) ? w.x : -w.y, b[u][2], b[u][3]);
    }
#pragma unroll
    for (int gp = 0; gp < NP; ++gp) {
      const float* are = f.buf + ((f.g0 + gp + 1) * 2 * f.rows + ra) * N1;  // the pair's leaf: its C rows
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t ab[4], as[4];
        a_fragment<P>(are, are + f.rows * N1, (f.mw + i) * 16, f.gid, f.tig, ab, as);
#pragma unroll
        for (int u = 0; u < NTL; ++u) {  // the k-step's sum on the tensor cores, added to acc in FP32
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, as, b[u][0], b[u][2]);
          mma_tf32(d, ab, b[u][1], b[u][3]);
          mma_tf32(d, ab, b[u][0], b[u][2]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gp * NTL + u][i][e] += d[e];
        }
      }
    }
  }
}

// fold_chunk at the warp's (np, ntl): every NP * NTL <= SW is instantiated.
template <int P, int MT, int SW, int NP = 1, int NTL = 1>
__device__ __forceinline__ void fold_any(float (&acc)[SW][MT][4], int np, int ntl, const FoldArgs& f) {
  if constexpr (NP <= SW) {
    if constexpr (NP * NTL <= SW) {
      if (np == NP && ntl == NTL) {
        fold_chunk<P, MT, SW, NP, NTL>(acc, f);
        return;
      }
      fold_any<P, MT, SW, NP, NTL + 1>(acc, np, ntl, f);
    } else {
      fold_any<P, MT, SW, NP + 1, 1>(acc, np, ntl, f);
    }
  }
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

// Thread 0: tile td of gcc_pair.wide_tiles (receivers of slots 0 ..
// MAX_SRC - 1, the pairs in the tile, then per pair its index and whether X
// is the leaf)
// on one channel's spectra cre/cim [B][n]; the l2rx floor from the
// channel's per-receiver maxima csmax [B] (FRESH: written earlier in the
// same launch, read through L2), windows to cout [P][width].
template <bool FRESH>
__device__ __forceinline__ void load_tile(Tile& tile, const int* td, const float* cre, const float* cim,
                                          const float* csmax, float* cout, size_t n, int width, int gate,
                                          float eps2) {
  tile.npairs = td[MAX_SRC];
  tile.nsrc = td[MAX_SRC] + 1;
  for (int s = 0; s < tile.nsrc; ++s) {
    tile.src[2 * s] = cre + td[s] * n;
    tile.src[2 * s + 1] = cim + td[s] * n;
  }
  for (int g = 0; g < tile.npairs; ++g) {
    const int leaf_x = td[MAX_SRC + 2 + 2 * g];
    tile.xs[g] = leaf_x ? g + 1 : 0;
    tile.ys[g] = leaf_x ? 0 : g + 1;
    const int bi = td[tile.xs[g]], bj = td[tile.ys[g]];
    tile.floor2[g] =
        gate == rm_pair::GATE_L2RX ? eps2 * (rm_pair::load<FRESH>(csmax + bi) * rm_pair::load<FRESH>(csmax + bj))
                                   : 0.f;
    tile.l1_floor[g] = 0.f;
    tile.out[g] = cout + static_cast<size_t>(td[MAX_SRC + 1 + 2 * g]) * width;
  }
}

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
template <int NT>
__device__ __forceinline__ float pair_scale(const float* xr, const float* xi, const float* yr, const float* yi,
                                            int n, int gate, float* red) {
  const int tid = threadIdx.x;
  float v = 0.f;  // |R|^2 and mag are >= 0
  for (int m = tid; m < n; m += NT) {
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
  for (int w = 1; w < NT / 32; ++w) s = fmaxf(s, red[w]);
  __syncthreads();  // red is written again by the next pair
  return s;
}

// Dynamic shared memory of the body, in floats: two buffers of nsrc
// sources x 2 planes x rows rows of n1; the block's window rows of W2,
// ntg*4 rows of n2; the warp FFT's twiddle table; the inverse twiddle's
// two factors, ceil(n/256) + 256 values.
template <int N1>
__host__ __device__ constexpr int buffer_floats(int nsrc, int rows) {
  return nsrc * 2 * rows * N1;
}

__host__ __device__ constexpr int tw_hi_count(int n) { return (n + TW_LO - 1) / TW_LO; }

__host__ __device__ inline size_t smem_floats(int n1, int n2, int nsrc, int rows, int ntg) {
  return 2 * static_cast<size_t>(nsrc) * 2 * rows * n1 + 2 * static_cast<size_t>(twiddle_count(n1)) +
         2 * static_cast<size_t>(ntg) * 4 * n2 + 2 * static_cast<size_t>(tw_hi_count(n1 * n2) + TW_LO);
}

// One tile (t.npairs pairs on t.nsrc sources) on NT threads. sm: the
// dynamic shared memory (smem_floats), 16-byte aligned. ntg: n-tiles a pair
// in this block (SLOTS<N1> / pairs at most), cg its group: n-tiles
// cg*ntg .. (cg + 1)*ntg - 1 of the window's nt = ceil((nneg + npos) / 4).
// twx: the inverse twiddle's factors W_n^(256a) (a < ceil(n/256)), then
// W_n^b (b < 256). A block may run the body again on another tile after a
// __syncthreads (kernel K8).
template <int N1, int NT = THREADS>
__device__ __forceinline__ void wide_pair_body(
    Tile& t, int gate, float eps2, float eps, const float2* __restrict__ wi, const float2* __restrict__ w2,
    const float2* __restrict__ twx, float* sm, int max_src, int n2, int nneg, int npos, int max_lag,
    float inv_n, int rows, int ntg, int cg) {
  using L = Layout<N1, NT>;
  constexpr int P = N1 / 32;
  constexpr int WARPS = L::WARPS, MT = L::MT, SW = L::SW;
  __shared__ uint64_t bars[2];
  __shared__ float red[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int mw = (warp % (WARPS / L::SG)) * MT;  // this warp's first m-tile
  const int nw = nneg + npos;
  const int nt = (nw + 3) / 4;
  const int bstride = buffer_floats<N1>(max_src, rows);
  float* buf0 = sm;
  float2* w2s = reinterpret_cast<float2*>(sm + 2 * bstride);  // [ntg*4][n2]: window rows of W2
  float2* twt = w2s + ntg * 4 * n2;                              // the warp FFT's twiddles
  float2* twh = twt + twiddle_count(N1);                         // inverse twiddle factors: hi, then lo
  const int nh = tw_hi_count(N1 * n2);
  const float2* twl = twh + nh;
  const int nchunks = (n2 + rows - 1) / rows;

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < (P - 1) * 32; i += NT) twt[i] = reg_twiddle<N1>(wi, i >> 5, i & 31);
  if constexpr (!rm_fft::is_pow2(P)) {
    if (tid < N1 / 128) {  // rm_fft::q_roots: W_q^u, the conjugate of W_q^(q - u) above q/2
      constexpr int Q = N1 / 128;
      const int u = tid <= Q / 2 ? tid : Q - tid;
      const float2 w = u == 0 ? make_float2(1.f, 0.f) : wi[u * (N1 / Q)];
      twt[(P - 1) * 32 + tid] = tid <= Q / 2 ? w : make_float2(w.x, -w.y);
    }
  }
  for (int i = tid; i < 4 * 32; i += NT) {  // the shuffle stages h = 16 >> s, s < 4
    const int h = 16 >> (i >> 5), l = i & 31;
    twt[shuffle_base(N1) + i] = (l & h) ? __ldg(wi + (l & (h - 1)) * (N1 / 2 / h)) : make_float2(1.f, 0.f);
  }
  for (int i = tid; i < ntg * 4 * n2; i += NT) {  // zero past the window's last row
    const int qw = cg * ntg * 4 + i / n2, k2 = i % n2;
    const int q = qw < nneg ? n2 - nneg + qw : qw - nneg;
    w2s[i] = qw < nw ? __ldg(w2 + static_cast<size_t>(q) * n2 + k2) : make_float2(0.f, 0.f);
  }
  for (int i = tid; i < nh + TW_LO; i += NT) twh[i] = __ldg(twx + i);
  // this block's earlier generic accesses to the buffers (K8: its row), and
  // global writes a barrier made visible (K8: the spectra), before the copies
  fence_proxy_async();
  fence_proxy_async_global();
  __syncthreads();  // barriers, tables and the tile visible

  if (warp == 0) {
    stage_chunk<N1>(t, buf0, &bars[0], 0, rows, n2, lane);
    if (nchunks > 1) stage_chunk<N1>(t, buf0 + bstride, &bars[1], 1, rows, n2, lane);
  }

  // l2 / l1: each pair's scale, while the first chunks arrive
  if (gate == rm_pair::GATE_L2 || gate == rm_pair::GATE_L1) {
    const int n = N1 * n2;
    for (int g = 0; g < t.npairs; ++g) {
      const float s = pair_scale<NT>(t.src[2 * t.xs[g]], t.src[2 * t.xs[g] + 1], t.src[2 * t.ys[g]],
                                     t.src[2 * t.ys[g] + 1], n, gate, red);
      if (tid == 0) {
        if (gate == rm_pair::GATE_L2) t.floor2[g] = __fmul_rn(eps2, s);
        t.l1_floor[g] = __fmul_rn(eps, s);
      }
    }
    __syncthreads();
  }

  const int p0 = P * static_cast<int>(__brev(lane) >> 27);  // this lane's first time p
  const int kb = swz_lo<P>(p0);  // swz_wide(p0 + d, rr) = (p0 + (d ^ kb)) ^ 8*(rr & 3)

  float acc[SW][MT][4];
#pragma unroll
  for (int j = 0; j < SW; ++j) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.f;
    }
  }
  // this warp's pairs g0 .. g0 + wnp - 1 and n-tiles nj0 .. nj0 + wntl - 1
  // of the block's ntl (group cg): all of them in a 256-thread block; in
  // K8's 512 threads a pair each half, or a half each of one pair's
  // n-tiles
  const int ntl = min(ntg, nt - cg * ntg);
  int wnp = t.npairs, wntl = ntl, g0 = 0, nj0 = 0;
  if constexpr (L::SG == 2) {
    const int h = warp / (WARPS / 2), a = (ntl + 1) / 2;
    wnp = 1;
    if (t.npairs == 2) {
      g0 = h;
    } else {
      wntl = h ? ntl - a : a;
      nj0 = h ? a : 0;
    }
  }
  static_assert(L::SG <= 2, "K8 splits the slots in two halves");

  for (int k = 0; k < nchunks; ++k) {
    float* buf = buf0 + (k & 1) * bstride;
    const int r0 = k * rows;
    const int krows = (min(rows, n2 - r0) + 3) & ~3;  // whole k-steps of 4 rows
    mbar_wait(&bars[k & 1], (k >> 1) & 1);

    // the inner FFT: job (g, rr) = pair g, chunk row rr, one a warp
    for (int job = warp; job < t.npairs * krows; job += WARPS) {
      const int g = job / krows, rr = job - g * krows;
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
        inverse_row_fft_wide<N1>(v, twt, lane);
        __syncwarp();  // every lane's reads of the leaf's row are done
        // TW[k2][p0 + d] = W_n^(k2*p0) * (W_n^k2)^d (k2*p < n): two table
        // factors each, then a product a time
        const int e0 = k2 * p0;
        const float2 w = rm_ct::cmul(twh[e0 / TW_LO], twl[e0 % TW_LO]);
        const float2 step = rm_ct::cmul(twh[k2 / TW_LO], twl[k2 % TW_LO]);
        store_c<P>(v, w, step, cre, cim, p0, kb, (rr & 3) << 3);
      } else {  // past the last row, in the last k-step: C = 0
        for (int i = lane; i < N1; i += 32) {
          cre[i] = 0.f;
          cim[i] = 0.f;
        }
      }
    }
    __syncthreads();

    if (wntl > 0) fold_any<P, MT, SW>(acc, wnp, wntl, FoldArgs{buf, w2s, krows, rows, r0, n2, g0, nj0, mw, gid, tig});
    fence_proxy_async();
    __syncthreads();  // buf is free: the copies of chunk k + 2 may land
    if (warp == 0 && k + 2 < nchunks) stage_chunk<N1>(t, buf, &bars[k & 1], k + 2, rows, n2, lane);
  }
  if (tid == 0) {  // every wait is done: the next tile's body may initialise them again
    mbar_inval(&bars[0]);
    mbar_inval(&bars[1]);
  }

  // lags -L..-1 are the last L times of the neg rows, 0..L the first L + 1
  // of the pos rows: flat index qw*n1 + p - (nneg*n1 - L)
  const int width = 2 * max_lag + 1;
  const int base = nneg * N1 - max_lag;
#pragma unroll
  for (int j = 0; j < SW; ++j) {  // slot j: pair g0 + j / wntl, n-tile nj0 + j % wntl
    if (j >= wnp * wntl) continue;
    const int g = g0 + j / wntl;
    const int qw = (cg * ntg + nj0 + j % wntl) * 4 + tig;
    if (qw >= nw) continue;
    float* orow = t.out[g];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mw + i) * 16 + gid + 8 * h;
        const int f = qw * N1 + p - base;
        const float x = acc[j][i][2 * h], y = acc[j][i][2 * h + 1];
        if (f >= 0 && f < width) orow[f] = __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y))), inv_n);
      }
    }
  }
}

}  // namespace rm_wide
