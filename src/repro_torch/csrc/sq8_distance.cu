// sq8_distance: stage 1 of the two-stage SQ8 search path.
//
// Replaces the Pallas TPU kernel repro.kernels.sq8_distance
// (sq8_distance_pallas / _sq8_kernel, src/repro/kernels/sq8_distance.py:87,
// body at :30).  For every lane (b, l) whose eval flag is set, dequantize
// the neighbour's uint8 code row and emit
//
//   xhat  = lo + code * scale                       (per dimension)
//   delta = q_b - xhat
//   ad2   = sum delta^2                             (the estimate)
//   lb2   = max(ad2 - 2 * sum |delta| * eps, 0)     (a true lower bound)
//
// Lanes whose eval flag is clear load nothing and write +inf to both
// outputs: that skipped code-row read is the point of the two stages
// (DESIGN.md section 3).
//
// What bounds it on an H100: bytes.  The work per call is the code rows of
// the evaluated lanes (d bytes each, a quarter of the fp32 row) plus the
// [B, L] side arrays (nbrs 4 bytes, eval 1 byte in; ad2, lb2 4 bytes each
// out), the queries and the three [d] grid arrays, over 3.35 TB/s; the
// arithmetic (about 8 flops per element) stays below the fp32 rate.
//
// Design:
//   * grid (ceil(L / 16), B), 128 threads: each CTA owns 16 lanes of one
//     query row, so a tile runs as many small CTAs and every SM keeps many
//     independent row reads in flight;
//   * q, lo, scale and eps sit in shared memory (4 d floats);
//   * each warp takes 4 of the lanes; for an evaluated lane lane t of the
//     warp reads uchar4 chunks at elements 128*j + 4*t + c, so a 128-byte
//     code row is one coalesced transaction (scalar byte loads when
//     d % 4 != 0);
//   * two partials per thread (ad2 and the slack sum), each reduced with
//     the warp_rows.cuh butterfly.
//
// Bit-exactness with the plain PyTorch version (ref.sq8_estimate_ref):
// every product and sum uses __fmul_rn / __fadd_rn / __fsub_rn in the
// plain version's order (dequantize, difference, square or |delta| * eps,
// accumulate), the element order is warp_order_sum's, and the clamp keeps
// NaN, so ad2 and lb2 are bit-equal.
//
// The eval mask must already exclude ids outside [0, n_rows) (the wrapper
// folds that in): the kernel reads code rows unchecked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_rows.cuh"

namespace {

using warp_rows::kPass;
using warp_rows::kWarp;
constexpr int kWarpsPerCta = 4;
constexpr int kLanesPerCta = 16;

struct Sq8Acc {
  float ad2 = 0.0f;
  float slack = 0.0f;
};

__device__ __forceinline__ void add_code(Sq8Acc& a, unsigned code, int e,
                                         const float* q_s, const float* lo_s,
                                         const float* sc_s,
                                         const float* eps_s) {
  const float xhat =
      __fadd_rn(lo_s[e], __fmul_rn(static_cast<float>(code), sc_s[e]));
  const float delta = __fsub_rn(q_s[e], xhat);
  a.ad2 = __fadd_rn(a.ad2, __fmul_rn(delta, delta));
  a.slack = __fadd_rn(a.slack, __fmul_rn(fabsf(delta), eps_s[e]));
}

__global__ void __launch_bounds__(kWarpsPerCta * kWarp)
sq8_distance_kernel(const int32_t* __restrict__ nbrs,
                    const float* __restrict__ queries,
                    const float* __restrict__ lo,
                    const float* __restrict__ scale,
                    const float* __restrict__ eps,
                    const int8_t* __restrict__ eval_mask,
                    const uint8_t* __restrict__ codes,
                    float* __restrict__ ad2_out,
                    float* __restrict__ lb2_out, int L, int d, int vec4) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* lo_s = smem + d;
  float* sc_s = smem + 2 * d;
  float* eps_s = smem + 3 * d;
  const int b = blockIdx.y;
  const int lane0 = blockIdx.x * kLanesPerCta;
  const int tid = threadIdx.x;

  const float* q = queries + static_cast<size_t>(b) * d;
  for (int e = tid; e < d; e += blockDim.x) {
    q_s[e] = q[e];
    lo_s[e] = lo[e];
    sc_s[e] = scale[e];
    eps_s[e] = eps[e];
  }
  __syncthreads();

  const int warp = tid / kWarp;
  const int t = tid % kWarp;
  for (int s = warp; s < kLanesPerCta; s += kWarpsPerCta) {
    const int l = lane0 + s;
    if (l >= L) break;                       // warp-uniform
    const size_t o = static_cast<size_t>(b) * L + l;
    if (eval_mask[o] == 0) {                 // warp-uniform: no row load
      if (t == 0) {
        ad2_out[o] = __int_as_float(0x7f800000);
        lb2_out[o] = __int_as_float(0x7f800000);
      }
      continue;
    }
    const uint8_t* row = codes + static_cast<size_t>(nbrs[o]) * d;
    Sq8Acc a;
    for (int base = 0; base < d; base += kPass) {
      const int e0 = base + 4 * t;
      if (vec4) {
        if (e0 < d) {
          const uchar4 c = __ldg(reinterpret_cast<const uchar4*>(row + e0));
          add_code(a, c.x, e0, q_s, lo_s, sc_s, eps_s);
          add_code(a, c.y, e0 + 1, q_s, lo_s, sc_s, eps_s);
          add_code(a, c.z, e0 + 2, q_s, lo_s, sc_s, eps_s);
          add_code(a, c.w, e0 + 3, q_s, lo_s, sc_s, eps_s);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (e0 + c < d) {
            add_code(a, __ldg(row + e0 + c), e0 + c, q_s, lo_s, sc_s, eps_s);
          }
        }
      }
    }
    const float ad2 = warp_rows::warp_sum(a.ad2);
    const float slack = __fmul_rn(2.0f, warp_rows::warp_sum(a.slack));
    if (t == 0) {
      float lb2 = __fsub_rn(ad2, slack);
      lb2 = lb2 < 0.0f ? 0.0f : lb2;         // NaN stays NaN
      ad2_out[o] = ad2;
      lb2_out[o] = lb2;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sq8_distance_launch(const void* nbrs, const void* queries,
                                   const void* lo, const void* scale,
                                   const void* eps, const void* eval_mask,
                                   const void* codes, void* ad2_out,
                                   void* lb2_out, int B, int L, int d,
                                   int vec4, void* stream) {
  if (B == 0 || L == 0) return 0;
  const dim3 grid((L + kLanesPerCta - 1) / kLanesPerCta, B);
  sq8_distance_kernel<<<grid, kWarpsPerCta * kWarp, 4 * d * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nbrs), static_cast<const float*>(queries),
      static_cast<const float*>(lo), static_cast<const float*>(scale),
      static_cast<const float*>(eps), static_cast<const int8_t*>(eval_mask),
      static_cast<const uint8_t*>(codes), static_cast<float*>(ad2_out),
      static_cast<float*>(lb2_out), L, d, vec4);
  return static_cast<int>(cudaGetLastError());
}
