// warp_rows.cuh: the per-row reduction the port's row-reading kernels share.
//
// A warp reads a row this way.  Lane t of the warp holds the elements
// 128*j + 4*t + c (c = 0..3) of pass j, accumulates its terms in (j, c)
// order starting from 0, and the 32 lane partials are then summed with a
// __shfl_xor_sync butterfly (strides 16, 8, 4, 2, 1).  Every product and
// sum is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn), so nvcc
// cannot contract anything into an FMA.  repro_torch/kernels/ref.py
// (warp_order_sum) adds in exactly this order, so the kernels' row sums are
// bit-equal with the plain versions'.
//
// Used by fused_expand.cu, gather_distance.cu and sq8_distance.cu: a warp
// owns a few lanes of a query row and reads their rows R at a time, so that
// R rows' reads are in flight together; each row keeps the element mapping
// and butterfly order above (l2sq_lanes is the whole fp32 row round trip
// of fused_expand and gather_distance).  kernels/build.py hashes this
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

// Rows a group keeps in flight when a warp owns `span` lanes and a row takes
// `np` passes: span row elements a thread, at least one row.
__host__ __device__ constexpr int rows_for(int span, int np) {
  return span / np > 0 ? span / np : 1;
}

// The sum of the 32 lane partials of each of R rows, left in every lane:
// the butterfly above, the R rows' shuffles interleaved with no branch
// between them.
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

// Round trip 2 of a warp that owns kSpan consecutive lanes (thread s <
// kSpan holds lane s's row id in `id`): |q - table[id]|^2 for every lane
// whose bit s is set in `fetch`, returned in thread s; +inf in every other
// thread.  The lanes go R = rows_for(kSpan, NP) at a time; every slot of a
// group loads a row (a lane that fetches nothing re-reads the group's first
// fetched row, lines already in flight), so the R loads issue together and
// the group runs with no branch.  `qv` holds the query's passes 0 .. NP-1
// when `one_sweep`; otherwise each sweep of NP passes reloads them from q.
// float4 loads when kVec (d % 4 == 0, table and q 16-byte aligned).
template <int kSpan, int NP, bool kVec>
__device__ __forceinline__ float l2sq_lanes(unsigned fetch, int id,
                                            const float* __restrict__ q,
                                            float4 (&qv)[NP], bool one_sweep,
                                            const float* __restrict__ table,
                                            int d, int t) {
  constexpr int R = rows_for(kSpan, NP);
  float mine = __int_as_float(0x7f800000);
#pragma unroll
  for (int g0 = 0; g0 < kSpan; g0 += R) {
    const unsigned gm = (fetch >> g0) & ((1u << R) - 1u);
    if (gm == 0) continue;                               // warp-uniform
    const int first = __shfl_sync(kFull, id, g0 + __ffs(gm) - 1);
    int rid[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int own = __shfl_sync(kFull, id, g0 + r);
      rid[r] = (gm >> r) & 1u ? own : first;
    }
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    for (int base = 0; base < d; base += NP * kPass) {
      if (!one_sweep) load_f32<NP, kVec>(qv, q, base, d, t);
      float4 x[R][NP];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        load_f32<NP, kVec>(x[r], table + static_cast<size_t>(rid[r]) * d,
                           base, d, t);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = l2sq_passes<NP>(acc[r], qv, x[r]);
    }
    warp_sum_rows<R>(acc);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (t == g0 + r && ((gm >> r) & 1u)) mine = acc[r];
    }
  }
  return mine;
}

}  // namespace warp_rows
