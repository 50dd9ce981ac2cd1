// gather_distance: exact squared L2 distance of each query to gathered rows.
//
// Replaces the Pallas TPU kernel repro.kernels.gather_distance
// (gather_distance_pallas / _gather_kernel,
// src/repro/kernels/gather_distance.py:53, body at :29) together with its
// masked form repro.kernels.ops.gather_distance_pruned
// (src/repro/kernels/ops.py:81).  For every lane (b, m), with ok = (0 <=
// idx < n_rows) and on = the lane's mask byte read in the call's polarity
// (compute: != 0, skip: == 0; no mask: every lane):
//
//   dist2 = (ok && on) ? |q_b - table[idx]|^2 : +inf
//
// The search engine calls it for the stage-2 rerank of the two-stage SQ8
// path ([B, W] in the hop loop, [B, efs] after it) and for the exact
// distances of the unfused engine ([B, W*M]), each with its own compute
// mask as it stands (bool), so no tensor op runs before the launch.
//
// What bounds it on an H100: bytes by the count, latency in fact.  The
// work per call is the rows of the lanes actually computed (4 d bytes
// each, one random read per lane) plus idx (4 bytes a lane), the mask (1
// byte a lane), the queries and the output: a few hundred rows at most in
// the search's calls, well under a microsecond at 3.35 TB/s, with 3 flops
// an element.  What a call costs is the launch and the chain of dependent
// global-memory round trips a warp waits through, so the design cuts that
// chain to two (ids, mask and query; then rows), as fused_expand.cu's
// does.  A lane not computed issues no load of its row.  On the TPU the
// Pallas kernel remapped skipped lanes to one pad row so that the
// pipeline de-duplicated their DMA; here such a lane loads nothing.
//
// Design (fused_expand.cu's launch form without the estimate):
//   * one warp owns kSpan = 4 consecutive lanes of one query row, and its
//     32 threads read those lanes' rows together; the grid is
//     B x ceil(M / 4) warps, one warp a CTA (no warp shares anything with
//     another: no block barrier, no shared copy of the query).  On the
//     H100 this beat fused_expand's CTAs of 4 warps at the hop loop's
//     rerank [128, 4] and the unfused tile [128, 128], most of it from
//     the code built for 32-thread CTAs (__launch_bounds__); an empty
//     launch of many one-warp CTAs costs more, which shows on the final
//     rerank when it has no lane to compute (PERF.md);
//   * round trip 1: thread t < 4 loads its lane's id and mask byte and,
//     beside them, every thread loads elements 128*j + 4*t + c of the
//     query into registers; the range check (negative ids included) is the
//     kernel's own, and __ballot_sync gives the warp its mask of rows to
//     fetch;
//   * round trip 2 (warp_rows.cuh's l2sq_lanes): the warp takes its lanes
//     R = 4 / passes at a time (all 4 at d <= 128); each slot loads a row,
//     its lane's or the group's first fetched row again, so the R loads
//     (float4, or scalar where d % 4 != 0 or the table or queries are not
//     16-byte aligned) issue together and the group runs with no branch;
//     d beyond 8 passes (1024) is swept 8 passes at a time, the query
//     reloaded each sweep, so any d is taken;
//   * each lane writes its own dist2 once.
//
// Bit-exactness with the plain PyTorch version (ref.gather_distance_ref):
// every row keeps warp_rows.cuh's order (lane t accumulates elements
// 128*j + 4*t + c in (j, c) order without FMA contraction, then a
// butterfly over strides 16, 8, 4, 2, 1), which l2sq_rows in ref.py
// follows exactly, so the distances are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_rows.cuh"

namespace {

using warp_rows::kFull;
using warp_rows::kPass;
using warp_rows::kWarp;
constexpr int kSpan = 4;               // lanes a warp owns
constexpr int kWarpsPerCta = 1;
constexpr int kMaxPasses = 8;          // query elements held in registers

struct GatherArgs {
  const int32_t* idx;
  const uint8_t* mask;        // null: every lane
  const float* queries;
  const float* table;
  float* dist;
  long long n_rows;
  int B, M, d, chunks;
  int mask_computes;          // 1: a set byte computes; 0: it skips
};

// One warp owns kSpan consecutive lanes of one query row; NP passes of the
// query in registers, float4 loads when kVec.
template <int NP, bool kVec>
__global__ void __launch_bounds__(kWarpsPerCta * kWarp)
gather_distance_kernel(const GatherArgs a) {
  const int t = threadIdx.x % kWarp;
  const int gw = blockIdx.x * kWarpsPerCta + threadIdx.x / kWarp;
  const int b = gw / a.chunks;
  if (b >= a.B) return;                                  // warp-uniform
  const int m = (gw - b * a.chunks) * kSpan + t;
  const bool live = t < kSpan && m < a.M;
  const size_t o = static_cast<size_t>(b) * a.M + m;
  const float* q = a.queries + static_cast<size_t>(b) * a.d;
  // NP covers d in one sweep but at the widest instantiation
  const bool one_sweep = NP < kMaxPasses || a.d <= NP * kPass;

  // round trip 1: id, mask byte and the query's elements, all in flight
  int id = -1;
  bool on = false;
  if (live) {
    id = a.idx[o];
    on = a.mask == nullptr || (a.mask[o] != 0) == (a.mask_computes != 0);
  }
  float4 qv[NP];
  if (one_sweep) warp_rows::load_f32<NP, kVec>(qv, q, 0, a.d, t);
  const unsigned fetch =
      __ballot_sync(kFull, on && id >= 0 && id < a.n_rows);

  // round trip 2: the fetched lanes' rows, every load of a group at once
  const float mine = warp_rows::l2sq_lanes<kSpan, NP, kVec>(
      fetch, id, q, qv, one_sweep, a.table, a.d, t);
  if (live) a.dist[o] = mine;
}

// CTAs of kWarpsPerCta warps over B x ceil(M / kSpan) warps.
long long grid_blocks(int B, int M) {
  const long long n_warps =
      static_cast<long long>(B) * ((M + kSpan - 1) / kSpan);
  return (n_warps + kWarpsPerCta - 1) / kWarpsPerCta;
}

// The grid's warps are numbered with an int.
bool grid_fits(int B, int M) {
  return grid_blocks(B, M) * kWarpsPerCta <= 0x7fffffffLL;
}

// The launch floor: no work, the kernel's grid and block.
__global__ void gather_distance_empty() {}

template <int NP>
void launch_np(const GatherArgs& a, int vec4, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(grid_blocks(a.B, a.M));
  if (vec4) {
    gather_distance_kernel<NP, true><<<blocks, kWarpsPerCta * kWarp, 0, s>>>(
        a);
  } else {
    gather_distance_kernel<NP, false><<<blocks, kWarpsPerCta * kWarp, 0, s>>>(
        a);
  }
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  idx [B, M]
// int32, mask [B, M] bytes (bool, int8 or uint8; may be null: every lane),
// read as "compute" when mask_computes is 1 and as "skip" when it is 0,
// queries [B, d] and table [n_rows, d] f32, dist_out [B, M] f32, all
// contiguous.  Any id is taken: one outside [0, n_rows) reads no row.
// `vec4`: d % 4 == 0 with 16-byte aligned table and queries.
extern "C" int gather_distance_launch(const void* idx, const void* mask,
                                      int mask_computes, const void* queries,
                                      const void* table, long long n_rows,
                                      void* dist_out, int B, int M, int d,
                                      int vec4, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (B < 0 || M < 0 || d <= 0 || !grid_fits(B, M)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GatherArgs a;
  a.idx = static_cast<const int32_t*>(idx);
  a.mask = static_cast<const uint8_t*>(mask);
  a.queries = static_cast<const float*>(queries);
  a.table = static_cast<const float*>(table);
  a.dist = static_cast<float*>(dist_out);
  a.n_rows = n_rows;
  a.B = B;
  a.M = M;
  a.d = d;
  a.chunks = (M + kSpan - 1) / kSpan;
  a.mask_computes = mask_computes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= kPass) {
    launch_np<1>(a, vec4, s);
  } else if (d <= 2 * kPass) {
    launch_np<2>(a, vec4, s);
  } else if (d <= 4 * kPass) {
    launch_np<4>(a, vec4, s);
  } else {
    launch_np<kMaxPasses>(a, vec4, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid and block a [B, M] launch takes (the launch
// floor chip_smoke.py times beside the kernel).
extern "C" int gather_distance_empty_launch(int B, int M, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (B < 0 || M < 0 || !grid_fits(B, M)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gather_distance_empty<<<static_cast<unsigned>(grid_blocks(B, M)),
                          kWarpsPerCta * kWarp, 0,
                          static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
