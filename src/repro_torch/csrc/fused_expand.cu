// fused_expand: the CRouting expansion step for one [B, L] neighbour tile.
//
// Replaces the Pallas TPU kernel repro.kernels.fused_expand
// (fused_expand_pallas / _expand_kernel, src/repro/kernels/fused_expand.py:106,
// body at :43).  For every lane (b, l) of the tile:
//
//   est2  = max((ed*ed + dcq*dcq) - ((2*ed)*dcq)*ct, 0)      no vector data
//   prune = prune_eligible && est2 >= bound2
//   dist2 = (eval && !prune) ? |q_b - table[nbr]|^2 : +inf
//
// What bounds it on an H100: bytes.  The work per call is the rows of the
// lanes that are actually computed (compute lanes x d x 4 bytes, one random
// 512-byte read each at d = 128) plus the [B, L] side arrays (23 bytes a
// lane) and the queries, over 3.35 TB/s; the arithmetic (3 flops per element)
// is far below the fp32 rate.  A pruned or masked lane issues no load of its
// row: that skipped read is the point of CRouting (DESIGN.md section 3).
//
// Design:
//   * grid (ceil(L / 16), B), 128 threads: each CTA owns 16 lanes of one
//     query row, so a 128 x 256 tile runs as 2048 small CTAs and every SM
//     keeps many independent row reads in flight (the reads are latency
//     bound, not bandwidth bound, at these sizes);
//   * the query row sits in shared memory;
//   * phase 1: 16 threads evaluate the estimate and prune of the CTA's lanes
//     (side arrays are read once, coalesced) and write +inf for every lane
//     that will not be fetched;
//   * phase 2: each warp takes 4 of the lanes; for a fetched lane the whole
//     warp reads the row with coalesced float4 loads (scalar loads when
//     d % 4 != 0 or the table is not 16-byte aligned) and reduces with a
//     __shfl_xor_sync butterfly.
//
// Bit-exactness with the plain PyTorch version (repro_torch/kernels/ref.py):
//   * the estimate uses __fmul_rn / __fadd_rn / __fsub_rn in the plain
//     version's order, so nvcc cannot contract it into FMAs and the prune
//     mask is bit-equal (NaN estimates never prune, as in jnp.maximum);
//   * the row sum is warp_rows.cuh's (lane t accumulates elements
//     128*j + 4*t + c in (j, c) order without FMA contraction, then a
//     butterfly over strides 16, 8, 4, 2, 1): l2sq_rows in ref.py sums in
//     exactly this order.
//
// No wgmma or TMA: a row per lane is a gather, not a tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_rows.cuh"

namespace {

using warp_rows::kWarp;
constexpr int kWarpsPerCta = 4;
constexpr int kLanesPerCta = 16;

__global__ void __launch_bounds__(kWarpsPerCta * kWarp)
fused_expand_kernel(const int32_t* __restrict__ nbrs,
                    const float* __restrict__ queries,
                    const float* __restrict__ ed,
                    const float* __restrict__ dcq,
                    const float* __restrict__ bound2,
                    const int8_t* __restrict__ eval_mask,
                    const int8_t* __restrict__ prune_eligible,
                    const float* __restrict__ table,
                    float* __restrict__ dist_out,
                    int8_t* __restrict__ prune_out,
                    int L, int d, float ct, int vec4) {
  extern __shared__ float q_s[];
  __shared__ int fetch_s[kLanesPerCta];
  const int b = blockIdx.y;
  const int lane0 = blockIdx.x * kLanesPerCta;
  const int tid = threadIdx.x;

  const float* q = queries + static_cast<size_t>(b) * d;
  for (int e = tid; e < d; e += blockDim.x) q_s[e] = q[e];

  if (tid < kLanesPerCta) {
    const int l = lane0 + tid;
    int do_fetch = 0;
    if (l < L) {
      const size_t o = static_cast<size_t>(b) * L + l;
      const float e_ = ed[o];
      const float c_ = dcq[o];
      float est2 = __fsub_rn(__fadd_rn(__fmul_rn(e_, e_), __fmul_rn(c_, c_)),
                             __fmul_rn(__fmul_rn(__fmul_rn(2.0f, e_), c_), ct));
      est2 = est2 < 0.0f ? 0.0f : est2;
      const bool prune = prune_eligible[o] != 0 && est2 >= bound2[o];
      prune_out[o] = prune ? 1 : 0;
      do_fetch = (eval_mask[o] != 0) && !prune;
      if (!do_fetch) dist_out[o] = __int_as_float(0x7f800000);
    }
    fetch_s[tid] = do_fetch;
  }
  __syncthreads();

  const int warp = tid / kWarp;
  const int t = tid % kWarp;
  for (int s = warp; s < kLanesPerCta; s += kWarpsPerCta) {
    if (!fetch_s[s]) continue;   // warp-uniform: pruned lanes load nothing
    const size_t o = static_cast<size_t>(b) * L + lane0 + s;
    const float* row = table + static_cast<size_t>(nbrs[o]) * d;
    const float acc =
        warp_rows::warp_sum(warp_rows::l2sq_partial(row, q_s, d, vec4, t));
    if (t == 0) dist_out[o] = acc;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  Masks
// must already exclude ids outside [0, n_rows): the kernel reads rows
// unchecked.
extern "C" int fused_expand_launch(const void* nbrs, const void* queries,
                                   const void* ed, const void* dcq,
                                   const void* bound2, const void* eval_mask,
                                   const void* prune_eligible,
                                   const void* table, void* dist_out,
                                   void* prune_out, int B, int L, int d,
                                   float cos_theta, int vec4, void* stream) {
  if (B == 0 || L == 0) return 0;
  const dim3 grid((L + kLanesPerCta - 1) / kLanesPerCta, B);
  fused_expand_kernel<<<grid, kWarpsPerCta * kWarp, d * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nbrs), static_cast<const float*>(queries),
      static_cast<const float*>(ed), static_cast<const float*>(dcq),
      static_cast<const float*>(bound2),
      static_cast<const int8_t*>(eval_mask),
      static_cast<const int8_t*>(prune_eligible),
      static_cast<const float*>(table), static_cast<float*>(dist_out),
      static_cast<int8_t*>(prune_out), L, d, cos_theta, vec4);
  return static_cast<int>(cudaGetLastError());
}
