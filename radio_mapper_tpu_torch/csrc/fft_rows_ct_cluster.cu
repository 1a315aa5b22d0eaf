// Kernels K3 and K1 at n1 = 128 or 256, the cluster design: forward
// CT-order FFT of [rows, n] rows, n = n1*n2 with n2 = 8*r <= 1024, one row
// a thread-block cluster of c = 2, 4 or 8 blocks, in one pass through
// device memory; with DETECT on, K1: the spectral detection too, in the
// same pass. (n1 = 384, 640 or 896 take the wide design,
// fft_detect_cluster.cuh.)
//
// Replaces radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows_ct (body
// fft_kernel.ct_fft_core) above n = 24576, where the one-block design
// (fft_rows_ct.cu) no longer holds a row, and, with DETECT,
// radio_mapper_tpu/ops/pallas/detect_kernel.py::fft_detect_rows_ct
// (ct_fft_core + detect_kernel._detect_body) at every n1 = 128/256 length,
// with emit_topk too (the TOPK instantiation; the one-block K1,
// fft_detect.cu, and the cluster K3 -> K4 are the card's comparison).
// Python wrappers:
// radio_mapper_tpu_torch/ops/cuda/fft_rows.py (long_rows; long_geometry
// picks c) and fft_detect.py (cluster_detect; cluster_geometry picks c
// with the power buffer, and block 0's detect columns); K8's long design
// runs K1's. tests/test_torch_cluster_fft.py replays the column ownership
// and the DSMEM pull map in numpy, tests/test_torch_long_rows_radix.py step
// B's thread map, tests/test_torch_k1_cluster_narrow.py the detect half.
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
//             K3 stores it; DETECT: each value's power (rm_det::power) to
//             pw[slot row - rank*n2/c][k1] and the block's max.
//   cluster barrier: no block exits while a partner reads it (K3 ends).
//   floor     (DETECT) slot row sr = k*r + s is CT row k2 = k + 8*s, so
//             block 0's first r slot rows are the CT rows k2 = 0 mod 8,
//             the stride-8 natural subsample, at any c: block 0 writes
//             their dB values over its free column buffer, finds the noise
//             floor from one order statistic (ct_detect.cuh floor_select;
//             bisect_floor for a bucket of ties), takes the row max over
//             the c blocks' maxima and writes the floor into every block's
//             shared memory before its half of a split cluster barrier.
//   detect    block 0 takes dcols0 columns after its floor (the share that
//             ends with the others': 3/8 of n1 at c = 2, 1/8 at 4, none at
//             8), blocks 1 .. c-1 the rest in quads; each pulls its
//             columns' power in natural order with `radius` circular halo
//             bins, CT row k2 from block (k2 mod 8)/(8/c), row ((k2 mod 8)
//             mod (8/c))*r + k2/8 (one 16-byte DSMEM load for 4 columns),
//             then runs ct_detect.cuh's window_partials (the float4 sliding
//             max, the gates but the confidence gate, the lane-pair segment
//             partials) and, once the floor is here, gate_partials: the
//             wide design's code, fed from this layout. A last cluster
//             barrier: no block exits while a partner pulls its powers.
//   top-K     (TOPK, emit_topk = K in 1 .. 128) in place of gate_partials:
//             each block takes its own first K staged segments in (score
//             desc, segment f asc) order, ungated, before the floor
//             arrives, and arrives at the floor's barrier only then. For
//             K <= 8, the flagship's (ct_detect.cuh topk_block8): the
//             K-th largest of the warps' largest keys bounds the block's
//             K-th from below, the dozen or so segments at or above it are
//             gathered and ranked by one warp (sorting networks in
//             registers where more than 32 reach it), and the list goes
//             through DSMEM into an inbox at the end of the merger's
//             column buffer; the merger (the block that holds column 0:
//             block 0, or block 1 at c = 8) reads the c lists locally
//             after the barrier (topk_merge8) and no block reads a
//             partner after it, so that barrier is the kernel's last. For
//             larger K (topk_block: warp passes, a rank merge) the lists
//             stay at the start of each block's column buffer, the merger
//             pulls them (topk_merge) and a last barrier follows. The
//             merger gates the lists (the confidence gate is monotone in
//             the score: a list's passing entries are its first) and
//             writes the row's [128] values and packed 8*f + offset
//             (lanes past the row's candidates take segment 0's gated
//             offset, as the reference's passes do). The F/8 partials are
//             never written.
//
// c is the least of 2, 4, 8 for which two blocks' n*8/c bytes (and the
// 64-entry W_128 table; K1: and the power buffer's n*4/c) fit one SM, so
// two 512-thread blocks an SM (64 registers a thread) hide each other's
// loads and barriers; where none does (K3: n > 113664; K1: n > 76800), the
// least for which one block fits 227 KB. K1 and K3 may take another c at
// one length (20480, 24576: K1 4, K3 2): the values do not depend on it.
//
// Each sample is read once and its spectrum written once, 16 B a sample
// (the workspace design moves 32; K3 -> K4 reads the spectra back: 24 B),
// plus K1's partials; the spectra equal the workspace design's and, where
// both take a length, the one-block design's bit for bit, and K1's
// partials, floor and row max equal the one-block K1's and the cluster K3
// -> K4's (every detect step is a max, a min, a count, an order statistic
// or a float32 comparison; card tests, tools/forward_times.py digests),
// its top-K blocks those of the one-block K1 and of K3 -> K4's top-K
// phase (tests/test_torch_k1_topk_cluster.py replays the selection).
// Bound on the H100: device-memory bytes, 0.165 ms at [1024, 33792] at
// 3.35 TB/s (K1: 0.176); the direct r-point DFT of step B is most of the
// time, then, for K1, the floor and the detect half (PERF.md).

#include <cuda_runtime.h>

#include <math_constants.h>

#include <cstdint>

#include "cluster.cuh"
#include "ct_detect.cuh"
#include "ct_fft.cuh"

namespace {

using rm_fft::THREADS;  // 512 a block; two blocks an SM where their shared memory fits (64 registers)
using rm_fft::WARPS;
using rm_det::DetectParams;

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

// Step C on one gathered slot row sr and its store at the CT addresses
// of K3; with DETECT each value's power (rm_det::power, no FMA
// contraction: K4's expression on the stored spectra) also goes to
// pwrow[k1] and into lmax.
template <int R1, bool DETECT>
__device__ __forceinline__ void step_c_store(float2 (&v)[R1 / 32], const float2* w1, float* fre, float* fim,
                                             size_t off, int sr, int r, float* pwrow, float& lmax) {
  constexpr int P = R1 / 32;
  rm_fft::step_c_regs<R1>(v, w1);
  const int b5 = static_cast<int>(__brev(threadIdx.x & 31) >> 27);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const size_t m = off + rm_fft::ct_address<R1>(sr, k, A, r);
    fre[m] = v[k].x;
    fim[m] = v[k].y;
    if constexpr (DETECT) {
      const float pv = rm_det::power(v[k].x, v[k].y);
      pwrow[rm_fft::digit<P>(k) * 32 + b5] = pv;
      lmax = fmaxf(lmax, pv);
    }
  }
}

// The power of CT (k2, k1) for rm_det::pull_natural: CT row k2 is slot row
// sr = (k2 mod 8)*r + k2/8, held by block sr / (n2/c) as its row sr mod
// (n2/c) of pw, read through DSMEM. g = 8/c: the values of k2 mod 8 a
// block holds.
struct SlotPower {
  const float* pw;
  int n1, r, g;
  __device__ __forceinline__ uint32_t at(int k2, int k1) const {
    const int k = k2 % A;
    return rm_cluster::dsmem(pw + ((k % g) * r + k2 / A) * n1 + k1, static_cast<unsigned>(k / g));
  }
  __device__ float4 quad(int k2, int k1) const { return rm_cluster::ld4(at(k2, k1)); }
  __device__ float one(int k2, int k1) const { return rm_cluster::ld1(at(k2, k1)); }
};

// The detect columns [d0, d0 + dn) of block `rank` of c: dcols0 on block 0
// (a multiple of 4, the share that ends with its floor), the rest split
// over blocks 1 .. c-1 in quads as evenly as they go (the first blocks
// one quad more). fft_detect.cluster_columns is the same split.
__host__ __device__ __forceinline__ void detect_columns(int rank, int n1, int c, int dcols0, int& d0, int& dn) {
  if (rank == 0) {
    d0 = 0;
    dn = dcols0;
    return;
  }
  const int quads = (n1 - dcols0) / 4, per = quads / (c - 1), extra = quads % (c - 1), b = rank - 1;
  dn = 4 * (per + (b < extra ? 1 : 0));
  d0 = dcols0 + 4 * (b * per + (b < extra ? b : extra));
}

// TOPK (with DETECT): K1 with emit_topk = topk, the row's [128] block of
// top-K values and packed indices to seg_score/seg_arg in place of the
// partials; an instantiation of its own, so the partials' code is unchanged.
template <int R1, int COLS, bool DETECT, bool TOPK>
__global__ void __launch_bounds__(THREADS, 2)
ct_cluster_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                  const float2* __restrict__ w1, const float2* __restrict__ wn2,
                  const float2* __restrict__ wp, const float2* __restrict__ tw,
                  float* __restrict__ fre, float* __restrict__ fim, float* __restrict__ seg_score,
                  float* __restrict__ seg_arg, float* __restrict__ nf_out, float* __restrict__ rmax_out,
                  int c, int n2, int r, DetectParams prm, int dcols0, int topk) {
  static_assert(DETECT || !TOPK, "the top-K is the detect half's");
  constexpr int P = R1 / 32;
  extern __shared__ float4 smem[];  // float4: the row pass reads 16 bytes at a time
  float2* xs = reinterpret_cast<float2*>(smem);  // [tiles][n2][COLS], this block's columns
  const int own = R1 / c;  // columns a block owns
  const int tiles = own / COLS;
  float2* w128s = xs + static_cast<size_t>(own) * n2;  // [64] W_128^e
  float* pw = reinterpret_cast<float*>(w128s + 64);  // [n2/c][R1] the power of its slot rows (DETECT)
  const int rank = static_cast<int>(rm_cluster::rank());
  const int tid = static_cast<int>(threadIdx.x);
  const size_t row = blockIdx.x / c;
  const size_t off = row * R1 * n2;
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
  // DSMEM, ROWS slot rows a warp in flight (their loads issued first): two
  // at P = 4, but one in K1's 32-column instantiation, which ran faster so
  // on the card (17408, 33792), where the 16-column one ran slower
  constexpr int ROWS = P <= 4 && !(DETECT && COLS == 32) ? 2 : 1;
  const int per = n2 / c;
  const int sr0 = rank * per;
  float lmax = -CUDART_INF_F;
  for (int i = tid >> 5; i < per; i += ROWS * WARPS) {
    float2 v[ROWS][P];
#pragma unroll
    for (int b = 0; b < ROWS; ++b)
      if (i + b * WARPS < per) gather<R1, COLS>(xs, c, n2, sr0 + i + b * WARPS, v[b]);
#pragma unroll
    for (int b = 0; b < ROWS; ++b)
      if (i + b * WARPS < per)
        step_c_store<R1, DETECT>(v[b], w1, fre, fim, off, sr0 + i + b * WARPS, r, pw + (i + b * WARPS) * R1, lmax);
  }
  if constexpr (!DETECT) {
    rm_cluster::sync();  // no block exits while a partner reads its columns
  } else {
    __shared__ float red_f[WARPS];
    __shared__ int red_i[WARPS];
    __shared__ float2 red_lh[WARPS];
    __shared__ float s_lmax, s_nf;
    lmax = rm_det::block_reduce<THREADS>(lmax, rm_det::MaxOp(), red_f);
    if (tid == 0) s_lmax = lmax;
    rm_cluster::sync();  // the partners' gathers are done; every block's powers are complete

    // ---- floor (block 0: its slot rows 0 .. r-1 are the CT rows k2 = 0
    // mod 8, the stride-8 subsample) and row max; block 0 writes its floor
    // into every block's s_nf before its half of a split cluster barrier
    float* aux = reinterpret_cast<float*>(xs);  // free: block 0's dB values, then every block's pull
    const int s_all = r * R1;  // n/8: the subsample's size, the row's segments
    if (rank == 0) {
      const float bmax = tid < c ? rm_cluster::ld1(rm_cluster::dsmem(&s_lmax, static_cast<unsigned>(tid)))
                                 : -CUDART_INF_F;
      const float nf = rm_det::subsample_floor<THREADS>(pw, s_all, aux, prm, red_lh, red_i);
      if (tid < c) rm_cluster::st1(rm_cluster::dsmem(&s_nf, static_cast<unsigned>(tid)), nf);
      if (tid < 32) {
        float rmax = bmax;
#pragma unroll
        for (int o = 1; o < A; o <<= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
        if (tid == 0) {
          nf_out[row] = nf;
          rmax_out[row] = rmax;
        }
      }
    }
    if constexpr (!TOPK) rm_cluster::arrive();  // block 0: its floor is in every block's s_nf

    // ---- this block's detect columns (block 0's after its floor), pulled
    // in natural order from the blocks that hold each CT row; the sliding
    // max, the gates but the confidence gate and the segment partials;
    // after the floor arrives the confidence gate and the stores
    int d0, dn;
    detect_columns(rank, R1, c, dcols0, d0, dn);
    float* nat = aux;                                   // [rad | dn*n2 | rad]
    float* st_sc = nat + dn * n2 + 2 * prm.radius + 4;  // [r][dn] staged partials (after the windows' overrun)
    float* st_sa = st_sc + r * dn;
    rm_det::pull_natural<THREADS>(nat, d0, dn, R1, n2, prm.radius, SlotPower{pw, R1, r, A / c});
    rm_det::window_partials<THREADS>(nat, d0, dn, n2, prm, st_sc, st_sa);
    __syncthreads();
    if constexpr (!TOPK) {
      rm_cluster::wait();    // the floor is here
      rm_cluster::arrive();  // this block's pulls are done
      rm_det::gate_partials<THREADS>(st_sc, st_sa, d0, dn, R1, r, row * s_all, s_nf, prm, seg_score, seg_arg);
      rm_cluster::wait();  // no block exits while a partner pulls its powers
    } else {
      // ---- emit_topk: this block's own list of its ungated segments (over
      // its freed columns, the same offset in every block) while block 0
      // finds the floor; the block that holds column 0 (segment 0's gated
      // offset fills the lanes past the row's candidates) gates and merges
      const int merger = dcols0 > 0 ? 0 : 1;
      float* tk = aux;
      float* vals = seg_score + row * rm_det::TOPK_LANES;
      float* packed = seg_arg + row * rm_det::TOPK_LANES;
      if (topk <= rm_det::TOPK_FAST) {  // each list into the merger's inbox: no partner is read after the barrier
        float* inbox = aux + 2 * own * n2 - rm_det::TOPK_INBOX;  // the column buffer's last floats
        rm_det::topk_block8<THREADS>(st_sc, st_sa, r, dn, d0, R1, topk, tk, inbox, rank, merger,
                                     rm_cluster::Partners{});
        rm_cluster::arrive();  // block 0: its floor is in every block's s_nf; this block's pulls and store are done
        rm_cluster::wait();
        if (rank == merger) rm_det::topk_merge8<THREADS>(inbox, tk, c, topk, s_nf, prm, vals, packed);
      } else {
        rm_det::topk_block<THREADS>(st_sc, st_sa, r, dn, d0, R1, topk, tk);
        rm_cluster::arrive();  // block 0: its floor is in every block's s_nf; this block's pulls and list are done
        rm_cluster::wait();
        if (rank == merger) {  // arrives once every partner's list is read
          rm_det::topk_merge<THREADS>(tk, c, topk, s_nf, prm, vals, packed, rm_cluster::Partners{});
        } else {
          rm_cluster::arrive();
        }
        rm_cluster::wait();  // no block exits while the merger reads its list
      }
    }
  }
}

size_t smem_bytes(int n1, int n2, int c, bool detect) {
  const size_t cols = (static_cast<size_t>(n1 / c) * n2 + 64) * sizeof(float2);
  return cols + (detect ? static_cast<size_t>(n2 / c) * n1 * sizeof(float) : 0);
}

// The column tile of a block that owns n1/c columns (long_geometry's rule).
int cols_for(int n1, int n2, int c) { return (n2 <= 512 && (n1 / c) % 32 == 0) ? 32 : 16; }

using Kernel = void (*)(const float*, const float*, const float2*, const float2*, const float2*, const float2*,
                        float*, float*, float*, float*, float*, float*, int, int, int, DetectParams, int, int);

// The instantiation for (n1, COLS, detect, top-K): only those the planned
// lengths reach (fft_rows.long_geometry, fft_detect.cluster_geometry;
// tests/test_torch_long_rows_radix.py lists them), nullptr otherwise.
template <bool DETECT, bool TOPK>
Kernel variant(int n1, int cols) {
  if (n1 == 128 && cols == 32) return ct_cluster_kernel<128, 32, DETECT, TOPK>;
  if (n1 == 128 && cols == 16) return ct_cluster_kernel<128, 16, DETECT, TOPK>;
  if (n1 == 256 && cols == 32) return ct_cluster_kernel<256, 32, DETECT, TOPK>;
  return nullptr;
}

// The kernel for a row of n1*n2 = n1*8*r on clusters of c, or nullptr
// where the shape is not one this design takes. topk > 0: K1's top-K
// instantiation (detect on).
Kernel kernel_for(int n1, int n2, int a, int r, int c, bool detect, int topk = 0) {
  if (a != A || a * r != n2 || n2 > MAX_N2 || (c != 2 && c != 4 && c != 8)) return nullptr;
  if (n1 % (16 * c) != 0 || n2 % c != 0 || smem_bytes(n1, n2, c, detect) > SMEM_LIMIT) return nullptr;
  const int cols = cols_for(n1, n2, c);
  if (!detect) return variant<false, false>(n1, cols);
  return topk > 0 ? variant<true, true>(n1, cols) : variant<true, false>(n1, cols);
}

// The detect half fits the freed column buffer (2*n/c floats): block 0's
// dB values with floor_select's histogram and bucket, and every block's
// natural-order columns with their halos, the windows' overrun and the
// staged partials (fft_detect.cluster_geometry checks the same); dcols0 a
// multiple of 4 that leaves every other block a quad; 2 <= radius <= n2.
bool detect_fits(int n1, int n2, int r, int c, int dcols0, int radius) {
  const size_t buf = static_cast<size_t>(2) * (n1 / c) * n2;
  if (radius < 2 || radius > n2 || dcols0 < 0 || dcols0 % 4 || (n1 - dcols0) / 4 < c - 1) return false;
  if (static_cast<size_t>(r) * n1 + rm_det::FLOOR_NB + THREADS > buf) return false;
  const int quads = (n1 - dcols0) / 4, most = 4 * (quads / (c - 1) + (quads % (c - 1) ? 1 : 0));
  const size_t dn = static_cast<size_t>(dcols0 > most ? dcols0 : most);
  return dn * n2 + 2 * static_cast<size_t>(radius) + 4 + 2 * static_cast<size_t>(r) * dn <= buf;
}

// With emit_topk = k (1 .. 128) the top-K scratch fits too: each block's
// list and its warps' lists before its staged partials, the inbox (k <= 8)
// past everything else, the merger's c lists (k > 8) in the column buffer;
// a block's staged segments 8 a thread (fft_detect.topk_fits checks the
// same).
bool topk_fits(int n1, int n2, int r, int c, int dcols0, int radius, int k) {
  const int buf = 2 * (n1 / c) * n2;
  if (k < 1 || k > rm_det::TOPK_LANES) return false;
  if (r * n1 + rm_det::FLOOR_NB + THREADS + rm_det::TOPK_INBOX > buf) return false;  // block 0's floor
  for (int b = 0; b < c; ++b) {
    int d0, dn;
    detect_columns(b, n1, c, dcols0, d0, dn);
    if (dn > 0 && rm_det::topk_block_floats(k, WARPS, r * dn) > dn * n2 + 2 * radius + 4) return false;
    if (dn * n2 + 2 * radius + 4 + 2 * r * dn + rm_det::TOPK_INBOX > buf) return false;
    if (r * dn > THREADS * rm_det::TOPK_PER_LANE) return false;
  }
  return rm_det::topk_stage_floats(k, WARPS, c) <= buf;
}

}  // namespace

// w1: W_n1^e (e < n1/2); wn2, wr, tw: ct_plan.radix_tables and
// ct_constants' twiddle for this n; c: the cluster's blocks
// (fft_rows.long_geometry).
extern "C" int rm_fft_rows_ct_cluster(const float* xre, const float* xim, const float2* w1, const float2* wn2,
                                      const float2* wr, const float2* tw, float* fre, float* fim, int rows,
                                      int n1, int n2, int a, int r, int c, cudaStream_t stream) {
  const Kernel k = kernel_for(n1, n2, a, r, c, false);
  if (k == nullptr || rows <= 0 || rows > 0x7fffffff / c) return static_cast<int>(cudaErrorInvalidValue);
  const DetectParams none{};
  return rm_cluster::launch(k, rows * c, THREADS, smem_bytes(n1, n2, c, false), c, stream, xre, xim, w1, wn2, wr,
                            tw, fre, fim, static_cast<float*>(nullptr), static_cast<float*>(nullptr),
                            static_cast<float*>(nullptr), static_cast<float*>(nullptr), c, n2, r, none, 0, 0);
}

// The cluster's shape: shared memory a block and cudaOccupancyMaxActiveClusters.
extern "C" int rm_fft_rows_ct_cluster_info(int n1, int n2, int a, int r, int c, int* smem, int* clusters) {
  const Kernel k = kernel_for(n1, n2, a, r, c, false);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *smem = static_cast<int>(smem_bytes(n1, n2, c, false));
  return static_cast<int>(rm_cluster::occupancy(k, THREADS, smem_bytes(n1, n2, c, false), c, clusters));
}

// Kernel K1 at n1 = 128, 256: the same kernel with its detect half on.
// c: fft_detect.cluster_geometry's (the power buffer in the fit); dcols0:
// block 0's detect columns; 2 <= radius <= n2. Outputs as K1's: segment
// scores and offsets [rows, n/8], floor and row max [rows]; with topk = K
// in 1 .. 128 (emit_topk) the [rows, 128] top-K values and packed 8*f +
// offset in place of the partials.
extern "C" int rm_fft_detect_cluster(const float* xre, const float* xim, const float2* w1, const float2* wn2,
                                     const float2* wr, const float2* tw, float* fre, float* fim, float* seg_score,
                                     float* seg_arg, float* nf, float* rmax, int rows, int n1, int n2, int a, int r,
                                     int c, int dcols0, int radius, int keep_lo, int keep_hi, float thr_lin,
                                     int has_conf, float conf_cs, float off, int bisect_iters, int topk,
                                     cudaStream_t stream) {
  const Kernel k = kernel_for(n1, n2, a, r, c, true, topk);
  if (k == nullptr || rows <= 0 || rows > 0x7fffffff / c || !detect_fits(n1, n2, r, c, dcols0, radius) ||
      (topk != 0 && !topk_fits(n1, n2, r, c, dcols0, radius, topk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DetectParams prm{radius, keep_lo, keep_hi, thr_lin, has_conf, conf_cs, off, bisect_iters};
  return rm_cluster::launch(k, rows * c, THREADS, smem_bytes(n1, n2, c, true), c, stream, xre, xim, w1, wn2, wr,
                            tw, fre, fim, seg_score, seg_arg, nf, rmax, c, n2, r, prm, dcols0, topk);
}

// K1's cluster on this card (topk > 0: its top-K instantiation): dynamic
// shared memory a block, blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// cudaOccupancyMaxActiveClusters, registers a thread and local memory.
extern "C" int rm_fft_detect_cluster_info(int n1, int n2, int a, int r, int c, int topk, int* smem, int* blocks,
                                          int* clusters, int* registers, int* local_bytes) {
  const Kernel k = kernel_for(n1, n2, a, r, c, true, topk);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(n1, n2, c, true);
  *smem = static_cast<int>(bytes);
  cudaError_t e = rm_cluster::occupancy(k, THREADS, bytes, c, clusters);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, THREADS, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr{};
  e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
