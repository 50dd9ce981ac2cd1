// normalize_rows: each float32 row divided by its Euclidean norm.
//
// Replaces no Pallas TPU kernel.  It takes the host's pass off the batch
// path of a cosine index: before it, every batch of queries was normalised
// on the host in NumPy (core/distances.py preprocess_vectors: a norm, a
// division and a copy, three passes over the batch) and only then uploaded.
// Now search_on uploads the rows as they are and this kernel normalises
// them in place on the card:
//
//   out[i] = x[i] / max(|x[i]|_2, 1e-12)     (float32 in, sum and out)
//
// NumPy's formula: a division by the clamped norm, not a product with an
// rsqrt.  Built without fast-math, and every step is an explicit IEEE
// intrinsic (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn), so nvcc cannot
// contract or approximate any of them.  A NaN norm stays NaN.
//
// The sum of squares follows warp_rows.cuh's order: lane t of the warp that
// owns the row holds elements 128*j + 4*t + c, adds their squares in (j, c)
// order from 0, and a __shfl_xor_sync butterfly combines the 32 lanes.  A
// row's bits therefore depend only on the row: not on the batch size, not
// on its position in the batch, not on whether 16-byte loads were possible
// (the scalar path keeps the same element order).  A serving session sends
// the same query in batches of many sizes.  kernels/ref.py's
// normalize_rows_ref computes the same sum (warp_order_sum) and equals this
// kernel bit for bit.
//
// What bounds it on an H100: bytes.  Each row is read once and written once
// (8 * B * d bytes: [10000, 1536] is 123 MB, 37 us at 3.35 TB/s); the
// arithmetic is ~3 operations an element.  Design: one warp a row, CTAs of
// kWarps warps; a lane loads its elements of up to NP passes at once
// (float4 loads where d % 4 == 0 and both pointers are 16-byte aligned,
// scalar loads otherwise), all in flight together, and keeps them in
// registers for the scaling, so a row of up to NP * 128 floats (NP = 12:
// d 1536) is read from memory once.  A wider row goes in sweeps of NP
// passes; its last sweep stays in registers and the others are read a
// second time, from L2 (a row is at most a few tens of KB).  The output may
// be the input (in place): each element is read before its own lane writes
// it, and never read after.  Launched on the caller's stream, no sync, no
// allocation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_rows.cuh"

namespace {

using warp_rows::kPass;

constexpr int kWarps = 8;                   // warps (rows) a CTA
constexpr int kThreads = kWarps * 32;
constexpr float kMinNorm = 1e-12f;          // NumPy's clamp, as float32

template <int NP>
__device__ __forceinline__ float add_squares(float acc,
                                             const float4 (&v)[NP]) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = warp_rows::f4_at(v[j], c);
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
  }
  return acc;
}

// Lane t's elements of passes base/128 .. base/128 + NP - 1, divided by
// `norm`, stored to the row `p` (nothing past d).
template <int NP, bool kVec>
__device__ __forceinline__ void scale_store(float* p, const float4 (&v)[NP],
                                            float norm, int base, int d,
                                            int t) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int e0 = base + j * kPass + 4 * t;
    const float4 o = make_float4(
        __fdiv_rn(v[j].x, norm), __fdiv_rn(v[j].y, norm),
        __fdiv_rn(v[j].z, norm), __fdiv_rn(v[j].w, norm));
    if constexpr (kVec) {
      if (e0 < d) *reinterpret_cast<float4*>(p + e0) = o;
    } else {
      if (e0 < d) p[e0] = o.x;
      if (e0 + 1 < d) p[e0 + 1] = o.y;
      if (e0 + 2 < d) p[e0 + 2] = o.z;
      if (e0 + 3 < d) p[e0 + 3] = o.w;
    }
  }
}

template <int NP, bool kVec>
__global__ void __launch_bounds__(kThreads)
normalize_rows_kernel(const float* x, float* out, long long B, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= B) return;                     // warp-uniform
  const int t = threadIdx.x & 31;
  const float* xr = x + static_cast<size_t>(row) * d;
  float* outr = out + static_cast<size_t>(row) * d;
  constexpr int kSweep = NP * kPass;
  float4 v[NP];
  float acc = 0.0f;
  int last = 0;                             // the last sweep's base
  for (int base = 0; base < d; base += kSweep) {
    warp_rows::load_f32<NP, kVec>(v, xr, base, d, t);
    acc = add_squares<NP>(acc, v);
    last = base;
  }
  float acc1[1] = {acc};
  warp_rows::warp_sum_rows<1>(acc1);
  float norm = __fsqrt_rn(acc1[0]);
  norm = norm < kMinNorm ? kMinNorm : norm;   // NaN stays NaN
  for (int base = 0; base < last; base += kSweep) {
    float4 w[NP];
    warp_rows::load_f32<NP, kVec>(w, xr, base, d, t);
    scale_store<NP, kVec>(outr, w, norm, base, d, t);
  }
  scale_store<NP, kVec>(outr, v, norm, last, d, t);
}

template <int NP>
cudaError_t launch(const float* x, float* out, long long B, int d, bool vec,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((B + kWarps - 1) / kWarps);
  if (vec) {
    normalize_rows_kernel<NP, true><<<blocks, kThreads, 0, stream>>>(
        x, out, B, d);
  } else {
    normalize_rows_kernel<NP, false><<<blocks, kThreads, 0, stream>>>(
        x, out, B, d);
  }
  return cudaGetLastError();
}

// Passes a sweep holds for rows of d floats: 1 (d <= 128), 4 (d <= 512),
// else 12 (one sweep up to d 1536).
int sweep_passes(long long d) {
  return d <= kPass ? 1 : d <= 4 * kPass ? 4 : 12;
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  x and out are
// [B, d] contiguous float32 (out may be x).
extern "C" int normalize_rows_launch(const void* x, void* out, long long B,
                                     long long d, void* stream) {
  if (B < 0 || d < 0 || d > 0x7fffffffLL - 12 * kPass ||
      (B + kWarps - 1) / kWarps > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || d == 0) return 0;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto xs = static_cast<const float*>(x);
  const auto os = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const int di = static_cast<int>(d);
  cudaError_t err;
  switch (sweep_passes(d)) {
    case 1: err = launch<1>(xs, os, B, di, vec, st); break;
    case 4: err = launch<4>(xs, os, B, di, vec, st); break;
    default: err = launch<12>(xs, os, B, di, vec, st); break;
  }
  return static_cast<int>(err);
}
