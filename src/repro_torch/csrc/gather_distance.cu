// gather_distance: exact squared L2 distance of each query to gathered rows.
//
// Replaces the Pallas TPU kernel repro.kernels.gather_distance
// (gather_distance_pallas / _gather_kernel,
// src/repro/kernels/gather_distance.py:53, body at :29) together with its
// masked form repro.kernels.ops.gather_distance_pruned
// (src/repro/kernels/ops.py:81).  For every lane (b, m):
//
//   dist2 = skip ? +inf : |q_b - table[idx]|^2
//
// The search engine calls it for the stage-2 rerank of the two-stage SQ8
// path ([B, W] in the hop loop, [B, efs] after it) and for the exact
// distances of the unfused engine ([B, W*M]).
//
// What bounds it on an H100: bytes.  The work per call is the rows of the
// lanes actually computed (d x 4 bytes each, one random read per lane) plus
// idx (4 bytes a lane), the skip mask (1 byte a lane), the queries and the
// output, over 3.35 TB/s; the arithmetic (3 flops per element) is far below
// the fp32 rate.  A skipped lane issues no load of its row.  On the TPU the
// Pallas kernel remapped skipped lanes to one pad row so that the pipeline
// de-duplicated their DMA; here a skipped lane simply loads nothing, so
// there is no remap.
//
// Design (fused_expand.cu's phase 2 without the estimate):
//   * grid (ceil(M / 16), B), 128 threads: each CTA owns 16 lanes of one
//     query row and keeps that query in shared memory;
//   * each warp takes 4 of the lanes; for a fetched lane the whole warp
//     reads the row with coalesced float4 loads (scalar loads when
//     d % 4 != 0 or the table is not 16-byte aligned) and reduces it with
//     warp_rows.cuh, the same order as fused_expand and as l2sq_rows in
//     ref.py: the reranked distances are bit-equal with the plain engine's.
//
// The skip mask must already include every id outside [0, n_rows) (the
// wrapper folds that in): the kernel reads rows unchecked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_rows.cuh"

namespace {

using warp_rows::kWarp;
constexpr int kWarpsPerCta = 4;
constexpr int kLanesPerCta = 16;

__global__ void __launch_bounds__(kWarpsPerCta * kWarp)
gather_distance_kernel(const int32_t* __restrict__ idx,
                       const int8_t* __restrict__ skip,
                       const float* __restrict__ queries,
                       const float* __restrict__ table,
                       float* __restrict__ dist_out, int M, int d,
                       int vec4) {
  extern __shared__ float q_s[];
  const int b = blockIdx.y;
  const int lane0 = blockIdx.x * kLanesPerCta;
  const int tid = threadIdx.x;

  const float* q = queries + static_cast<size_t>(b) * d;
  for (int e = tid; e < d; e += blockDim.x) q_s[e] = q[e];
  __syncthreads();

  const int warp = tid / kWarp;
  const int t = tid % kWarp;
  for (int s = warp; s < kLanesPerCta; s += kWarpsPerCta) {
    const int m = lane0 + s;
    if (m >= M) break;                       // warp-uniform
    const size_t o = static_cast<size_t>(b) * M + m;
    if (skip[o] != 0) {                      // warp-uniform: no row load
      if (t == 0) dist_out[o] = __int_as_float(0x7f800000);
      continue;
    }
    const float* row = table + static_cast<size_t>(idx[o]) * d;
    const float acc =
        warp_rows::warp_sum(warp_rows::l2sq_partial(row, q_s, d, vec4, t));
    if (t == 0) dist_out[o] = acc;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int gather_distance_launch(const void* idx, const void* skip,
                                      const void* queries, const void* table,
                                      void* dist_out, int B, int M, int d,
                                      int vec4, void* stream) {
  if (B == 0 || M == 0) return 0;
  const dim3 grid((M + kLanesPerCta - 1) / kLanesPerCta, B);
  gather_distance_kernel<<<grid, kWarpsPerCta * kWarp, d * sizeof(float),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const int8_t*>(skip),
      static_cast<const float*>(queries), static_cast<const float*>(table),
      static_cast<float*>(dist_out), M, d, vec4);
  return static_cast<int>(cudaGetLastError());
}
