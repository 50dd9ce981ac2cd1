// lanes.cuh: the per-lane side operands and the CRouting estimate that
// fused_expand.cu and crouting_prune.cu share.
//
// A float side operand (ed, dcq, bound2) is read at lane (b, l) through
// four numbers, (stride_b, stride_w, stride_m, m), as
// repro_torch/kernels/fused_expand.py's lane_strides computes them:
//
//   p[b*stride_b + (l / m)*stride_w + (l % m)*stride_m]
//
// which covers a [B] operand broadcast over the lanes (0, 0, m = L), a
// [B, L] one of any strides and a [B, W, M] one with W*M = L (e.g. a
// [B, W] tensor expanded over M with a zero stride), so no wrapper copies
// an operand into a dense [B, L] tile before a launch.
//
// The estimate keeps the plain version's order with every product and sum
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn), so nvcc cannot
// contract it into FMAs and it is bit-equal with ref.edge_angle_est2.
// kernels/build.py hashes this header into the library name of every
// source that includes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lanes {

// A float operand read at lane (b, l = w * m + i) through its strides;
// shift = log2(m) when m is a power of two (no division), else -1.
struct LaneF32 {
  const float* p;
  long long sb, sw, sm;
  int m, shift;
  __device__ __forceinline__ float at(int b, int l) const {
    const int w = shift >= 0 ? l >> shift : l / m;
    return __ldg(p + b * sb + w * sw + (l - w * m) * sm);
  }
};

inline int log2_or_minus1(long long m) {
  if (m <= 0 || (m & (m - 1)) != 0) return -1;
  int k = 0;
  while ((1LL << k) < m) ++k;
  return k;
}

// `out` for operand `p` from st[0..3] = (stride_b, stride_w, stride_m, m);
// false when m is not a positive int.
inline bool make_lane(LaneF32& out, const void* p, const long long* st) {
  const long long m = st[3];
  if (m <= 0 || m > 0x7fffffffLL) return false;
  out = LaneF32{static_cast<const float*>(p), st[0], st[1], st[2],
                static_cast<int>(m), log2_or_minus1(m)};
  return true;
}

// est2 = max((ed*ed + dcq*dcq) - ((2*ed)*dcq)*ct, 0), uncontracted; a NaN
// estimate (an inf edge length against a zero query distance) stays NaN,
// so it compares false and never prunes, as with jnp.maximum.
__device__ __forceinline__ float edge_est2(float ed, float dcq, float ct) {
  const float est2 =
      __fsub_rn(__fadd_rn(__fmul_rn(ed, ed), __fmul_rn(dcq, dcq)),
                __fmul_rn(__fmul_rn(__fmul_rn(2.0f, ed), dcq), ct));
  return est2 < 0.0f ? 0.0f : est2;
}

}  // namespace lanes
