// Shared device code of the GCC pair body: the cross-power R = X conj(Y)
// of one bin and its whitening, as gcc_pair_wide.cuh's wide_pair_body (the
// body of kernels K2, K5, K6 and of kernel K8's pair half, at every inner
// length n1) runs them; radio_mapper_tpu/ops/pallas/gcc_kernel.py::_whiten.
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

namespace rm_pair {

enum Gate : int { GATE_L2RX = 0, GATE_L2 = 1, GATE_L1 = 2, GATE_NONE = 3 };

// Scalar loads: read-only-cache loads where the data predate the launch;
// L2 loads (no L1) where another block of the same launch wrote them
// (kernel K8's row maxima).
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

}  // namespace rm_pair
