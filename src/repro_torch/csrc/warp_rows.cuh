// warp_rows.cuh: the per-row reduction the port's row-reading kernels share.
//
// One warp reads one row.  Lane t of the warp holds the elements
// 128*j + 4*t + c (c = 0..3) of pass j, accumulates its terms in (j, c)
// order starting from 0, and the 32 lane partials are then summed with a
// __shfl_xor_sync butterfly (strides 16, 8, 4, 2, 1).  Every product and
// sum is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn), so nvcc
// cannot contract anything into an FMA.  repro_torch/kernels/ref.py
// (warp_order_sum) adds in exactly this order, so the kernels' row sums are
// bit-equal with the plain versions'.
//
// Used by fused_expand.cu and gather_distance.cu (fp32 rows) and by
// sq8_distance.cu (its own uint8 loop over the same element mapping).
// kernels/build.py hashes this header into the library name of every
// source that includes it.

#pragma once

#include <cuda_runtime.h>

namespace warp_rows {

constexpr int kWarp = 32;
constexpr int kPass = kWarp * 4;   // elements one warp pass covers

__device__ __forceinline__ float add_sq(float acc, float q, float x) {
  const float df = __fsub_rn(q, x);
  return __fadd_rn(acc, __fmul_rn(df, df));
}

// Lane t's partial of |q - row|^2 (q in shared memory).  Coalesced float4
// loads when vec4 (d % 4 == 0 and a 16-byte aligned table), else scalar.
__device__ __forceinline__ float l2sq_partial(const float* __restrict__ row,
                                              const float* q_s, int d,
                                              int vec4, int t) {
  float acc = 0.0f;
  for (int base = 0; base < d; base += kPass) {
    const int e0 = base + 4 * t;
    if (vec4) {
      if (e0 < d) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(row + e0));
        acc = add_sq(acc, q_s[e0], x.x);
        acc = add_sq(acc, q_s[e0 + 1], x.y);
        acc = add_sq(acc, q_s[e0 + 2], x.z);
        acc = add_sq(acc, q_s[e0 + 3], x.w);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (e0 + c < d) acc = add_sq(acc, q_s[e0 + c], __ldg(row + e0 + c));
      }
    }
  }
  return acc;
}

// Sum of the 32 lane partials, left in every lane.
__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  return acc;
}

}  // namespace warp_rows
