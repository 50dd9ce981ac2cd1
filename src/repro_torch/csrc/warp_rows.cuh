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
// Used by gather_distance.cu (l2sq_partial, one row at a time) and by
// fused_expand.cu and sq8_distance.cu (the multi-row helpers below: a warp
// reads the rows of its lanes R at a time, so that R rows' reads are in
// flight together; each row keeps the element mapping and butterfly order
// above).  kernels/build.py hashes this
// header into the library name of every source that includes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_rows {

constexpr int kWarp = 32;
constexpr int kPass = kWarp * 4;   // elements one warp pass covers
constexpr unsigned kFull = 0xffffffffu;

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
    acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  }
  return acc;
}

// --- several rows at once ----------------------------------------------------

// warp_sum of R rows, their shuffles interleaved with no branch between
// them (each row's order is warp_sum's).
template <int R>
__device__ __forceinline__ void warp_sum_rows(float (&acc)[R]) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(kFull, acc[r], off));
    }
  }
}

// Lane t's four elements of passes base/128 .. base/128 + NP - 1 of a
// float row (zeros past d): float4 loads when kVec, else scalar.
template <int NP, bool kVec>
__device__ __forceinline__ void load_f32(float4 (&v)[NP],
                                         const float* __restrict__ p,
                                         int base, int d, int t) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int e0 = base + j * kPass + 4 * t;
    if constexpr (kVec) {
      v[j] = e0 < d ? __ldg(reinterpret_cast<const float4*>(p + e0))
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      v[j].x = e0 < d ? __ldg(p + e0) : 0.0f;
      v[j].y = e0 + 1 < d ? __ldg(p + e0 + 1) : 0.0f;
      v[j].z = e0 + 2 < d ? __ldg(p + e0 + 2) : 0.0f;
      v[j].w = e0 + 3 < d ? __ldg(p + e0 + 3) : 0.0f;
    }
  }
}

// Lane t's four codes of the same passes of a uint8 row (zeros past d):
// uchar4 loads when kVec, else bytes.
template <int NP, bool kVec>
__device__ __forceinline__ void load_u8(uchar4 (&v)[NP],
                                        const uint8_t* __restrict__ p,
                                        int base, int d, int t) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int e0 = base + j * kPass + 4 * t;
    if constexpr (kVec) {
      v[j] = e0 < d ? __ldg(reinterpret_cast<const uchar4*>(p + e0))
                    : make_uchar4(0, 0, 0, 0);
    } else {
      v[j].x = e0 < d ? __ldg(p + e0) : 0;
      v[j].y = e0 + 1 < d ? __ldg(p + e0 + 1) : 0;
      v[j].z = e0 + 2 < d ? __ldg(p + e0 + 2) : 0;
      v[j].w = e0 + 3 < d ? __ldg(p + e0 + 3) : 0;
    }
  }
}

__device__ __forceinline__ float f4_at(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned u4_at(const uchar4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// Lane t's partial of |q - x|^2 over NP passes, added to acc in (j, c)
// order.  q and x hold zeros past d (load_f32), so those terms are exact
// zeros: the sum is the one that stops at d, with no branch a term.
template <int NP>
__device__ __forceinline__ float l2sq_passes(float acc, const float4 (&q)[NP],
                                             const float4 (&x)[NP]) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc = add_sq(acc, f4_at(q[j], c), f4_at(x[j], c));
    }
  }
  return acc;
}

}  // namespace warp_rows
