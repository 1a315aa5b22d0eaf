// Kernel K1 for rows whose CT split has n1 = 384, 640 or 896 (every
// planned nfft from 52224 up, n2 = 136 ... 336; the flagship at block_len
// 57344 is 58368 = 384*152, at 96000 it is 97280 = 640*152): forward
// CT-order FFT + spectral detection of [rows, n] rows in one launch and
// one pass through device memory, a row on a thread-block cluster of C = 8
// blocks. Instantiated without its detect half it is kernel K3's long
// rows at these n1. The wide design (fft_rows.long_geometry "wide"), a
// template on n1 (R1): P = n1/32 = 4q points a lane in step C, q = 3, 5, 7.
//
// This header holds the kernel, a template on n1, and kernel_at, which
// picks an instantiation; fft_detect_cluster.cu instantiates n1 = 384 and
// holds the entries, fft_detect_cluster_mixed.cu instantiates 640 and 896.
// Apart, because nvcc compiles a kernel's code differently with other
// instantiations in its translation unit: with 640 and 896 beside it the
// n1 = 384 K1 ran 2-3% slower, bit for bit the same (PERF.md). With the
// detect parts shared with the cluster K1 (ct_detect.cuh), the n1 = 640
// and 896 K1 run about 3% slower than with the window detect written in
// the kernel (tools/forward_times.py --k1 beside that tree; PERF.md); no
// unit or form of the shared code tried on the card brought it back.
//
// Replaces radio_mapper_tpu/ops/pallas/detect_kernel.py::fft_detect_rows_ct
// (fft_kernel.ct_fft_core + detect_kernel._detect_body) and, with DETECT
// off, fft_kernel.py::fft_rows_ct at these lengths. Python wrappers:
// radio_mapper_tpu_torch/ops/cuda/fft_rows.py (wide_launch: K3) and
// fft_detect.py (wide_detect: K1), under fft_rows.fft_rows_ct_long,
// fft_detect.fft_detect_rows_ct_long and K8's long design
// (channel_step._long). tests/test_torch_k1_cluster.py replays
// the schedule, the pull map and the floor's rows in numpy at every n1.
//
// A row of n = n1*n2 samples, n2 = 8*r, is x[q][p] at time q*n1 + p.
// Block `rank` (512 threads, 16 warps) of the row's cluster:
//
//   columns  its OWN = n1/8 = 16q columns p = OWN*rank + [0, OWN): a thread
//            a (column, j) loads x[(j + r*t)*n1 + p], t < 8, to registers
//            and runs ct_fft.cuh's step A on them (the 8-point radix-2
//            FFT, W_128^e read as W_n1^(e*n1/128), then W_n2^(j*k)),
//            writing slots j + r*k of xs[q][p] (n bytes of float2); then
//            step B, the direct r-point DFT (r = 17 ... 42), in place from
//            shared memory, in rounds of whole column blocks: a thread an
//            item of 4 outputs s = 4*sq .. 4*sq + 3 of columns p, p + 1,
//            p + OWN/2, p + OWN/2 + 1 (two 16-byte loads of y_j, contiguous
//            across a quad of lanes, and the roots W_r^(j*s) from a table
//            padded to rows of 4*ceil(r/4)), its 16 outputs in registers
//            until one barrier ends the round's reads; every output acc =
//            sum over j of cmac(acc, W_r^(j*s), y_j) from zero in j order,
//            then times the row twiddle, as step_b and step_b_stream
//            compute it.
//   cluster barrier.
//   rows     its slot rows sr = rank*r + s (s < r), a warp each: lane l
//            gathers positions q*l + 32q*g + [0, q) (g < 4) from blocks
//            2*g + l/16 through DSMEM ((q + 1)/2 16-byte loads a g: with q
//            odd, every other lane's q values start between two 16-byte
//            words, so it loads from the word below and drops the first
//            value), the layout in which step C (row_fft: step_c_regs'
//            five radix-2 stages and the P-point mixed-radix transform, the
//            same butterflies in the same order) runs two stages in
//            registers and trades a lane bit for a register digit before
//            each other one, half the shuffles of step_c_regs; the spectra
//            stored at CT row k2 = rank + 8*s, as every K3 design stores
//            them, and (DETECT) each value's power, rm_det::power (no FMA
//            contraction: K4's expression on the stored spectra), to this
//            block's pw[s][k1], and the block's max power.
//   cluster barrier (the K3 instantiation ends here).
//   floor    the CT rows k2 = 0 mod 8, the detect body's stride-8 natural
//            subsample, are exactly block 0's rows at any n1: block 0 alone
//            writes their dB values over its free column buffer and finds
//            the noise floor from one order statistic (ct_detect.cuh
//            subsample_floor and floor_select: a histogram, then a rank of
//            one bucket's values; the 24 bisection steps then need no pass
//            over the values), takes the row max over the 8 blocks' maxima
//            and writes the floor into every block's shared memory before
//            its half of a split cluster barrier.
//   detect   meanwhile blocks 1 .. 7 take the detect columns (DCOLS = 56,
//            92, 128 each, the last 48, 88, 128; block 0 none): each pulls,
//            for its columns k1 and every k2, the power of CT (k2, k1) from
//            block k2 mod 8 (one 16-byte DSMEM load for 4 columns), with
//            `radius` halo bins of the neighbour columns (circular at k1 =
//            0 and n1 - 1), into natural order over its free column buffer;
//            then 4 bins a lane: the circular +/-radius sliding max (float4
//            window reads, the positions the 4 windows share maxed once),
//            ct_detect.cuh's gates but the confidence gate, and over the
//            lane pair of a segment its (max, lowest in-segment argmax);
//            after the floor arrives the confidence gate (monotone in the
//            power: a segment's best passes it or none of its bins does)
//            and the partials go out (ct_detect.cuh pull_natural,
//            window_partials, gate_partials: the code the cluster K1 at
//            n1 = 128/256, fft_rows_ct_cluster.cu, runs too). A last
//            cluster barrier: no block exits while a partner reads its
//            powers.
//   top-K    (TOPK, emit_topk = K in 1 .. 128) in place of the gate and
//            the partials' stores: blocks 1 .. 7 take their own first K
//            staged segments in (score desc, segment f asc) order,
//            ungated, while block 0 finds the floor (ct_detect.cuh
//            topk_block8 for K <= 8, topk_block above), and arrive at the
//            floor's barrier only then; block 1, which holds column 0,
//            gates and merges the 8 lists and writes the row's [128]
//            values and packed 8*f + offset. For K <= 8 each list goes
//            through DSMEM into an inbox at the end of block 1's column
//            buffer before the barrier, which is then the kernel's last
//            (topk_merge8); above, block 1 pulls the lists after it and a
//            last cluster barrier follows (topk_merge). No F/8 partials
//            are written.
//
// Every reduction is a max, a min, an integer count or an order statistic
// and the per-value arithmetic is the workspace K3's and K4's, so the
// spectra, partials, floor and row max equal the workspace K3 -> K4 bit
// for bit (card tests, tools/forward_times.py's long-row digests), and
// the top-K blocks K3 -> K4's top-K phase (block_topk's passes).
//
// Shared memory a block: xs (n bytes), with DETECT pw (n/2 bytes), and the
// tables (W_n1 and step C's twiddles, 190q float2: 4.5, 7.4, 10.4 KB):
// 92,064 B at 58368, 153,520 B at 97280. n1 = 384: two blocks an SM
// (__launch_bounds__ at most 64 registers a thread) up to nfft 70656 (K3:
// 101376), one above. n1 = 640, 896: one block an SM at up to 128
// registers a thread (step C's 40 or 56 values a lane); with the detect
// half one block fills an SM's shared memory. K3 at n1 = 640 where two
// blocks fit (nfft <= 102400) takes two at 64 registers (kernel_at picks
// the instantiation; rm_fft_detect_wide_info reports it and the card's
// occupancy).
//
// Bound on the H100: device-memory bytes, a row read once and its spectra
// written once (16 B a sample) and the partials (1 B a sample), 0.30 ms at
// [1024, 58368] at 3.35 TB/s (the workspace K3 -> K4 moved 48 B a sample);
// the time goes to step B's direct DFT (n*r complex FMAs a row), step C
// and, for K1, the floor on block 0 and the others' detect (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "cluster.cuh"
#include "ct_detect.cuh"
#include "ct_fft.cuh"

namespace {

using rm_det::DetectParams;
using rm_det::SEG;

constexpr int C = 8;                // blocks a row; block 0 holds the CT rows k2 = 0 mod 8
constexpr int A = 8;                // step A's length (8 | n2)
constexpr int THREADS = 512;        // fft_rows.WIDE_THREADS
constexpr int WARPS = THREADS / 32;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block

// The design's shape at n1 = R1 (384, 640, 896).
template <int R1>
struct Wide {
  static constexpr int P = R1 / 32;          // step C's points a lane
  static constexpr int Q = P / 4;            // its q-point DFTs: 3, 5, 7
  static constexpr int OWN = R1 / C;         // columns a block: 16q
  static constexpr int QPAIRS = OWN / 4;     // step B's column pair pairs (p, p + 1, p + OWN/2, p + OWN/2 + 1)
  static constexpr int DCOLS = 4 * ((R1 + 27) / 28);  // detect columns of blocks 1 .. 6 (56, 92, 128)
  static constexpr int MAX_R = 4 * (THREADS / QPAIRS);  // a column block's items (4 outputs x 4 columns) fit one round
  static constexpr int ROW_TW = 126 * Q;     // step C's twiddles (row_fft): (64 + 32 + 16 + 8 + 4 + 2)*q
  static constexpr size_t TABLE_BYTES = (R1 / 2 + ROW_TW) * sizeof(float2);  // W_n1, then step C's twiddles
  static_assert(P == 4 * Q && Q % 2 == 1 && OWN == 16 * Q && OWN % 4 == 0, "n1 = 128q, q odd");
};

__host__ __device__ constexpr int quads(int r) { return (r + 3) / 4; }  // step B's output quads

// Step B's table: W_r^(j*s) with rows padded to 4*quads(r).
__host__ __device__ constexpr size_t ab_bytes(int r) {
  return static_cast<size_t>(r) * 4 * quads(r) * sizeof(float2);
}

// Dynamic shared memory of a block: xs, then pw (DETECT; it holds step
// B's table until step C) or that table, then W_n1 and the stage
// twiddles.
template <int R1>
size_t smem_bytes(int n2, bool detect) {
  const size_t n = static_cast<size_t>(R1) * n2;
  return n + (detect ? n / 2 : ab_bytes(n2 / A)) + Wide<R1>::TABLE_BYTES;
}

// ---- step C in a register layout of its own ------------------------------
//
// Position p = i + P*b of a slot row (i < P, b < 32; i = 2q*i_hi +
// q*i_mid + u, u < q) is, in step_c_regs<n1>, point i of lane b: its five
// radix-2 stages pair lanes b, b ^ 16 .. b ^ 1 (h = 64q .. 4q) and its
// P-point transform runs two radix-2 stages (h = 2q on i_hi, q on i_mid)
// and the q-point DFTs on u in registers. Here register j = u + q*g of
// lane l holds p = q*l + 32q*g + u: the two top bits of b (b4, b3) are
// register digits (g = b3 + 2*b4) and lane l's bits are (b2 b1 b0 i_hi
// i_mid). So the stages on b4 and b3 run in registers, and each later
// stage first trades its lane bit for a register digit already done (a
// lane sends the half of its pairs the partner keeps, one shuffle a
// value), then runs the butterflies in registers: the same butterflies,
// twiddles and order as step_c_regs and mixed_regs, with half the
// shuffles. At the end lane l is b again, and register j holds bin
// (j/q + 4*(j mod q))*32 + brev5(l).
//
// Twiddles: the pair whose top register is j0 takes W_n1^e, e below by
// stage; rts holds them a stage, a u (and at h = 64q a g) and a lane class
// apart, so a warp reads consecutive float2s or broadcasts.

// W_n1 exponent of entry k of rts (its fill): stage h = 64q [g*q + u][l]:
// u + 32q*g + q*l; 32q [u][l]: 2*(u + q*l); 16q [u][l mod 16]: 4*(u +
// q*l); 8q [u][l mod 8]: 8*(u + q*l); 4q [u][l mod 4]: 16*(u + q*l); 2q
// [u][l mod 2]: 32*(u + q*l).
template <int R1>
__device__ __forceinline__ int row_tw_exponent(int k) {
  constexpr int Q = Wide<R1>::Q;
  if (k < 64 * Q) return k / 32 % Q + 32 * Q * (k / (32 * Q)) + Q * (k % 32);
  int o = 64 * Q, lanes = 32, scale = 2;
  while (k >= o + Q * lanes) { o += Q * lanes; lanes /= 2; scale *= 2; }
  return scale * ((k - o) / lanes + Q * ((k - o) % lanes));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// The radix-2 butterfly of step_c_regs (and of mixed_regs where mul):
// (a, b) -> (a + b, (a - b)*w).
__device__ __forceinline__ void butterfly(float2& a, float2& b, float2 w, bool mul = true) {
  const float2 d = csub(a, b);
  a = cadd(a, b);
  b = mul ? rm_ct::cmul(d, w) : d;
}

// Lanes l and l ^ d trade: the one with the bit set sends its digit-0
// value a and takes the partner's digit-1 value b, so afterwards a and b
// are the pair of the stage on that lane bit.
__device__ __forceinline__ void exchange(float2& a, float2& b, bool bit, int d) {
  const float2 send = bit ? a : b;
  const float2 recv = make_float2(__shfl_xor_sync(0xffffffffu, send.x, d), __shfl_xor_sync(0xffffffffu, send.y, d));
  a = bit ? recv : a;
  b = bit ? b : recv;
}

template <int R1>
__device__ __forceinline__ void row_fft(float2 (&v)[Wide<R1>::P], const float2* rts, const float2* w1s, int lane) {
  constexpr int P = Wide<R1>::P, Q = Wide<R1>::Q;
#pragma unroll
  for (int j = 0; j < 2 * Q; ++j) butterfly(v[j], v[j + 2 * Q], rts[j * 32 + lane]);  // h = 64q, b4
#pragma unroll
  for (int k = 0; k < 2 * Q; ++k) {  // h = 32q, b3: pairs j, j + q for j < q and 2q <= j < 3q
    const int j = k + k / Q * Q;
    butterfly(v[j], v[j + Q], rts[64 * Q + j % Q * 32 + lane]);
  }
  int o = 96 * Q;
#pragma unroll
  for (int d = 16; d >= 2; d >>= 1) {  // h = 16q, 8q, 4q (b2, b1, b0), then 2q (i_hi)
    const int wt = (d == 16 || d == 4) ? 2 * Q : Q;  // the register digit traded: b4, b3, b2, b1
    const bool bit = (lane & d) != 0;
    const float2* t = rts + o + (lane & (d - 1));
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if ((j / wt) % 2) continue;
      exchange(v[j], v[j + wt], bit, d);
      butterfly(v[j], v[j + wt], t[j % Q * d], d > 2 || j % Q != 0 || (lane & 1) != 0);
    }
    o += Q * d;
  }
  const bool bit = (lane & 1) != 0;  // h = q (i_mid), traded for b0; e = 64*u
#pragma unroll
  for (int j = 0; j < 2 * Q; ++j) {
    exchange(v[j], v[j + 2 * Q], bit, 1);
    butterfly(v[j], v[j + 2 * Q], w1s[64 * (j % Q)], j % Q != 0);
  }
  float2 wq[Q];
  rm_fft::q_roots<Q, R1>(w1s, wq);
  rm_fft::q_dfts<P>(v, wq);
}

// The power of CT (k2, k1) for rm_det::pull_natural: block k2 mod 8's
// pw[k2 / 8][k1], through DSMEM.
template <int R1>
struct RankPower {
  const float* pw;
  __device__ float4 quad(int k2, int k1) const {
    return rm_cluster::ld4(rm_cluster::dsmem(pw + (k2 / A) * R1 + k1, static_cast<unsigned>(k2 % A)));
  }
  __device__ float one(int k2, int k1) const {
    return rm_cluster::ld1(rm_cluster::dsmem(pw + (k2 / A) * R1 + k1, static_cast<unsigned>(k2 % A)));
  }
};

// MIN_BLOCKS: __launch_bounds__' blocks an SM, 2 (at most 64 registers a
// thread) or 1 (128): 2 at n1 = 384; at 640 K3's where two blocks fit an
// SM's shared memory (n2 <= 160; faster there, slower at 1 block by
// shared memory, where 64 registers only add spills); else 1. TOPK (with
// DETECT): emit_topk = topk, the row's [128] top-K block to
// seg_score/seg_arg in place of the partials, an instantiation of its own.
template <int R1, bool DETECT, int MIN_BLOCKS, bool TOPK>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fft_detect_cluster_kernel(const float* __restrict__ xre, const float* __restrict__ xim, const float2* __restrict__ w1,
            const float2* __restrict__ wn2, const float2* __restrict__ wr, const float2* __restrict__ tw,
            float* __restrict__ fre, float* __restrict__ fim, float* __restrict__ seg_score,
            float* __restrict__ seg_arg, float* __restrict__ nf_out, float* __restrict__ rmax_out, int n2, int r,
            DetectParams prm, int topk) {
  static_assert(DETECT || !TOPK, "the top-K is the detect half's");
  using W = Wide<R1>;
  constexpr int P = W::P, Q = W::Q, OWN = W::OWN, QPAIRS = W::QPAIRS, DCOLS = W::DCOLS;
  extern __shared__ float4 smem[];
  __shared__ float red_f[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ float2 red_lh[WARPS];
  __shared__ float s_lmax, s_nf;
  const int rq = quads(r), rp = 4 * rq;  // step B's output quads; wrs's row length
  float2* xs = reinterpret_cast<float2*>(smem);  // [n2][OWN] this block's columns
  float* pw = reinterpret_cast<float*>(xs + static_cast<size_t>(n2) * OWN);  // [r][R1] powers (DETECT)
  float2* wrs = reinterpret_cast<float2*>(pw);  // [r][rp] W_r^(j*s), until step C
  float2* w1s = reinterpret_cast<float2*>(
      reinterpret_cast<char*>(pw) + (DETECT ? static_cast<size_t>(r) * R1 * sizeof(float) : ab_bytes(r)));
  float2* rts = w1s + R1 / 2;  // [W::ROW_TW] step C's twiddles
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(rm_cluster::rank());
  const int n = R1 * n2;
  const size_t row = blockIdx.x / C;
  const size_t off = row * n;
  const int c0 = rank * OWN;

  for (int e = tid; e < r * rp; e += THREADS) {
    const int j = e / rp, s = e - j * rp;
    wrs[e] = s < r ? wr[j * r + s] : make_float2(0.f, 0.f);
  }
  for (int e = tid; e < R1 / 2; e += THREADS) w1s[e] = w1[e];
  for (int e = tid; e < W::ROW_TW; e += THREADS) rts[e] = w1[row_tw_exponent<R1>(e)];

  // ---- columns and step A: column p, j < r loads x[(j + r*t)*R1 + c0 + p]
  // (t < 8) to registers, runs the 8-point FFT (its twiddles from device
  // memory, so the tables above need no barrier of their own) and writes
  // slots j + r*t of xs[q][p]. W_128^e = W_n1^(e*n1/128) (the same
  // float32 values), so it rounds as every other design's does.
  {
    const float* xr = xre + off + c0;
    const float* xi = xim + off + c0;
#pragma unroll 2
    for (int u = tid; u < OWN * r; u += THREADS) {
      const int j = u / OWN, p = u - j * OWN;
      float2 v[A];
#pragma unroll
      for (int t = 0; t < A; ++t) {
        const size_t q = static_cast<size_t>(j + r * t) * R1 + p;
        v[t] = make_float2(__ldg(xr + q), __ldg(xi + q));
      }
      rm_fft::dif_regs<A, R1>(v, w1);
#pragma unroll
      for (int t = 0; t < A; ++t) {
        const int k = rm_fft::brev_bits(t, 3);
        xs[(j + r * k) * OWN + p] = k ? rm_ct::cmul(v[t], __ldg(wn2 + j * k)) : v[t];
      }
    }
  }
  __syncthreads();

  // ---- step B in place, kr column blocks a round. Item u of a round (one
  // a thread): column block k0 + u / per_k, outputs s = 4*sq .. 4*sq + 3,
  // columns p, p + 1 and p + OWN/2, p + OWN/2 + 1; a pass over j reads y_j of the
  // four columns (two 16-byte loads, each contiguous across the lanes of
  // a quad) and W_r^(j*s) of the four outputs (32 bytes), then 16 cmacs.
  {
    const int per_k = rq * QPAIRS;
    int kr = A;
    while (kr > 1 && kr * per_k > THREADS) kr /= 2;
#pragma unroll 1
    for (int k0 = 0; k0 < A; k0 += kr) {
      const int ku = tid / per_k, rem = tid - ku * per_k;
      const int k = k0 + ku, sq = rem / QPAIRS, p = 2 * (rem - sq * QPAIRS);
      const bool mine = tid < kr * per_k;
      float2 acc[4][4];  // output 4*sq + e, column p, p + 1, p + OWN/2, p + OWN/2 + 1
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[e][c] = make_float2(0.f, 0.f);
      if (mine) {
        const float2* yrow = xs + r * k * OWN + p;
        const float4* w4 = reinterpret_cast<const float4*>(wrs + 4 * sq);
#pragma unroll 2
        for (int j = 0; j < r; ++j, yrow += OWN, w4 += rp / 2) {
          const float4 wa = w4[0], wb = w4[1];
          const float2 w[4] = {make_float2(wa.x, wa.y), make_float2(wa.z, wa.w), make_float2(wb.x, wb.y),
                               make_float2(wb.z, wb.w)};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 y = *reinterpret_cast<const float4*>(yrow + h * (OWN / 2));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              rm_ct::cmac(acc[e][2 * h], w[e], make_float2(y.x, y.y));
              rm_ct::cmac(acc[e][2 * h + 1], w[e], make_float2(y.z, y.w));
            }
          }
        }
      }
      __syncthreads();  // every read of this round's column blocks is done
      if (mine) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 4 * sq + e;
          if (s < r) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = p + h * (OWN / 2);
              const float4 t = __ldg(reinterpret_cast<const float4*>(tw + static_cast<size_t>(k + A * s) * R1 + c0 + q));
              const float2 a = rm_ct::cmul(acc[e][2 * h], make_float2(t.x, t.y));
              const float2 b = rm_ct::cmul(acc[e][2 * h + 1], make_float2(t.z, t.w));
              *reinterpret_cast<float4*>(xs + (s + r * k) * OWN + q) = make_float4(a.x, a.y, b.x, b.y);
            }
          }
        }
      }
    }
  }
  rm_cluster::sync();  // every block's slot rows are complete

  // ---- step C: slot rows rank*r + s, one a warp, in row_fft's layout:
  // lane l's register q*g + u is position q*l + 32q*g + u, column q*(l mod
  // 16) + u of block 2*g + l/16, read as (q + 1)/2 16-byte loads from the
  // even column at or below q*(l mod 16) (an odd lane drops the first value)
  float lmax = -CUDART_INF_F;
  {
    constexpr int LOADS = (Q + 1) / 2;
    const bool odd = (lane & 1) != 0;
    const float2* src = xs + Q * (lane & 15) - (odd ? 1 : 0);
    const int b5 = static_cast<int>(__brev(static_cast<unsigned>(lane)) >> 27);
    for (int s = warp; s < r; s += WARPS) {
      float2 v[P];
      const float2* rowp = src + (rank * r + s) * OWN;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const unsigned owner = static_cast<unsigned>(2 * g + (lane >> 4));
        float2 f[2 * LOADS];
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          const float4 t = rm_cluster::ld4(rm_cluster::dsmem(rowp + 2 * i, owner));
          f[2 * i] = make_float2(t.x, t.y);
          f[2 * i + 1] = make_float2(t.z, t.w);
        }
#pragma unroll
        for (int u = 0; u < Q; ++u) v[Q * g + u] = odd ? f[u + 1] : f[u];
      }
      row_fft<R1>(v, rts, w1s, lane);
      const size_t base = off + static_cast<size_t>(rank + A * s) * R1;  // CT row k2 = rank + 8 s
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int k1 = (j / Q + 4 * (j % Q)) * 32 + b5;
        fre[base + k1] = v[j].x;
        fim[base + k1] = v[j].y;
        if constexpr (DETECT) {
          const float pv = rm_det::power(v[j].x, v[j].y);
          pw[s * R1 + k1] = pv;
          lmax = fmaxf(lmax, pv);
        }
      }
    }
  }
  if constexpr (DETECT) {
    lmax = rm_det::block_reduce<THREADS>(lmax, rm_det::MaxOp(), red_f);
    if (tid == 0) s_lmax = lmax;
  }
  rm_cluster::sync();  // the partners' gathers are done; every block's powers are complete
  if constexpr (!DETECT) return;

  // ---- floor (block 0: its rows are the stride-8 subsample) and row max
  float* aux = reinterpret_cast<float*>(xs);  // free: block 0's dB values, then every block's pull
  const int s_all = r * R1;  // n/8: the subsample's size, the row's segments
  if (rank == 0) {
    // the row max: lane q of warp 0 reads block q's max (one round trip)
    const float bmax = tid < C ? rm_cluster::ld1(rm_cluster::dsmem(&s_lmax, static_cast<unsigned>(tid))) : -CUDART_INF_F;
    const float nf = rm_det::subsample_floor<THREADS>(pw, s_all, aux, prm, red_lh, red_i);
    if (tid < C) rm_cluster::st1(rm_cluster::dsmem(&s_nf, static_cast<unsigned>(tid)), nf);
    if (warp == 0) {
      float rmax = bmax;
#pragma unroll
      for (int o = 1; o < C; o <<= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      if (tid == 0) {
        nf_out[row] = nf;
        rmax_out[row] = rmax;
      }
    }
  }
  if constexpr (!TOPK) rm_cluster::arrive();  // block 0: its floor is in every block's s_nf

  // ---- pull: this block's detect columns d0 .. d0 + dn - 1 (none on
  // block 0, which finds the floor meanwhile; DCOLS on blocks 1 .. 6, the
  // rest on block 7), the power of CT (k2, k1) from block k2 mod 8
  const int d0 = rank == 0 ? 0 : DCOLS * (rank - 1);
  const int dn = rank == 0 ? 0 : rank < C - 1 ? DCOLS : R1 - DCOLS * (C - 2);
  float* nat = aux;                                  // [rad | dn*n2 | rad]
  float* st_sc = nat + dn * n2 + 2 * prm.radius + 4;  // [r][dn] staged partials (after the windows' overrun)
  float* st_sa = st_sc + r * dn;
  rm_det::pull_natural<THREADS>(nat, d0, dn, R1, n2, prm.radius, RankPower<R1>{pw});

  // ---- detect: the sliding max, the gates but the confidence gate, the
  // segment partials; after the floor arrives the confidence gate
  rm_det::window_partials<THREADS>(nat, d0, dn, n2, prm, st_sc, st_sa);
  __syncthreads();
  if constexpr (!TOPK) {
    rm_cluster::wait();    // the floor is here
    rm_cluster::arrive();  // this block's pulls are done
    rm_det::gate_partials<THREADS>(st_sc, st_sa, d0, dn, R1, r, row * s_all, s_nf, prm, seg_score, seg_arg);
    rm_cluster::wait();  // no block exits while a partner pulls its powers
  } else {
    // ---- emit_topk: this block's own list of its ungated segments at the
    // start of its freed columns while block 0 finds the floor; block 1,
    // which holds column 0 (its segment 0's gated offset fills the lanes
    // past the row's candidates), gates and merges the 8 lists
    constexpr int MERGER = 1;
    float* tk = aux;
    float* vals = seg_score + row * rm_det::TOPK_LANES;
    float* packed = seg_arg + row * rm_det::TOPK_LANES;
    if (topk <= rm_det::TOPK_FAST) {  // each list into the merger's inbox: no partner is read after the barrier
      float* inbox = aux + n / 4 - rm_det::TOPK_INBOX;  // the column buffer's last floats
      rm_det::topk_block8<THREADS>(st_sc, st_sa, r, dn, d0, R1, topk, tk, inbox, rank, MERGER, rm_cluster::Partners{});
      rm_cluster::arrive();  // block 0: its floor is in every block's s_nf; this block's pulls and store are done
      rm_cluster::wait();
      if (rank == MERGER) rm_det::topk_merge8<THREADS>(inbox, tk, C, topk, s_nf, prm, vals, packed);
    } else {
      rm_det::topk_block<THREADS>(st_sc, st_sa, r, dn, d0, R1, topk, tk);
      rm_cluster::arrive();  // block 0: its floor is in every block's s_nf; this block's pulls and list are done
      rm_cluster::wait();
      if (rank == MERGER) {  // arrives once every partner's list is read
        rm_det::topk_merge<THREADS>(tk, C, topk, s_nf, prm, vals, packed, rm_cluster::Partners{});
      } else {
        rm_cluster::arrive();
      }
      rm_cluster::wait();  // no block exits while the merger reads its list
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float2*, const float2*, const float2*, const float2*,
                        float*, float*, float*, float*, float*, float*, int, int, DetectParams, int);

constexpr size_t SM_SMEM = 233472;    // 228 KB an SM for its blocks
constexpr size_t BLOCK_EXTRA = 1024 + 256;  // the runtime's reserve and the static shared memory a block, at most

// The instantiation for (n1, n2, detect, top-K) and its MIN_BLOCKS: 2 at
// n1 = 384, and for K3 at 640 where two blocks fit an SM's shared memory;
// else 1. rm_fft_detect_wide_info reports the choice; nothing else makes
// it. topk > 0: K1's top-K instantiation (detect on).
template <int R1>
Kernel kernel_at(int n2, int a, int r, int detect, int topk, int* min_blocks) {
  const size_t smem = smem_bytes<R1>(n2, detect != 0);
  if (a != A || a * r != n2 || r < 1 || r > Wide<R1>::MAX_R || smem > SMEM_LIMIT) return nullptr;
  const bool two = R1 == 384 || (R1 == 640 && !detect && 2 * (smem + BLOCK_EXTRA) <= SM_SMEM);
  *min_blocks = two ? 2 : 1;
  if constexpr (R1 == 384) {
    if (detect) {
      return topk > 0 ? fft_detect_cluster_kernel<R1, true, 2, true> : fft_detect_cluster_kernel<R1, true, 2, false>;
    }
    return fft_detect_cluster_kernel<R1, false, 2, false>;
  } else if constexpr (R1 == 640) {
    if (detect) {
      return topk > 0 ? fft_detect_cluster_kernel<R1, true, 1, true> : fft_detect_cluster_kernel<R1, true, 1, false>;
    }
    return two ? fft_detect_cluster_kernel<R1, false, 2, false> : fft_detect_cluster_kernel<R1, false, 1, false>;
  } else {
    if (detect) {
      return topk > 0 ? fft_detect_cluster_kernel<R1, true, 1, true> : fft_detect_cluster_kernel<R1, true, 1, false>;
    }
    return fft_detect_cluster_kernel<R1, false, 1, false>;
  }
}

// With emit_topk = k (1 .. 128) the top-K scratch fits the freed column
// buffer (n/4 floats): blocks 1 .. 7's lists and their warps' before their
// staged partials, the inbox (k <= 8) past everything else, the merger's 8
// lists (k > 8); a block's staged segments 8 a thread (fft_detect.topk_fits
// checks the same).
template <int R1>
bool topk_fits(int n2, int r, int radius, int k) {
  const int buf = R1 * n2 / 4;
  if (k < 1 || k > rm_det::TOPK_LANES) return false;
  if (r * R1 + rm_det::FLOOR_NB + THREADS + rm_det::TOPK_INBOX > buf) return false;  // block 0's floor
  for (int rank = 1; rank < C; ++rank) {
    const int dn = rank < C - 1 ? Wide<R1>::DCOLS : R1 - Wide<R1>::DCOLS * (C - 2);
    if (rm_det::topk_block_floats(k, WARPS, r * dn) > dn * n2 + 2 * radius + 4) return false;
    if (dn * n2 + 2 * radius + 4 + 2 * r * dn + rm_det::TOPK_INBOX > buf) return false;
    if (r * dn > THREADS * rm_det::TOPK_PER_LANE) return false;
  }
  return rm_det::topk_stage_floats(k, WARPS, C) <= buf;
}

}  // namespace

// n1 = 640, 896: kernel_at<640>, kernel_at<896> (fft_detect_cluster_mixed.cu).
Kernel rm_wide_kernel_mixed(int n1, int n2, int a, int r, int detect, int topk, int* min_blocks);
