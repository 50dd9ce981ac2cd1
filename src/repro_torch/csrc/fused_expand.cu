// fused_expand: the CRouting expansion step for one [B, L] neighbour tile.
//
// Replaces the Pallas TPU kernel repro.kernels.fused_expand
// (fused_expand_pallas / _expand_kernel, src/repro/kernels/fused_expand.py:106,
// body at :43).  For every lane (b, l) of the tile, with ok = (0 <= nbr <
// n_rows):
//
//   est2  = max((ed*ed + dcq*dcq) - ((2*ed)*dcq)*ct, 0)      no vector data
//   prune = ok && prune_eligible && est2 >= bound2
//   dist2 = (ok && eval && !prune) ? |q_b - table[nbr]|^2 : +inf
//
// What bounds it on an H100: bytes by the count, latency in fact.  The
// work per call is the rows of the lanes actually computed (4 d bytes each,
// one random read per lane) plus the side arrays and the queries, under a
// microsecond of bytes at the search's tiles; the arithmetic (3 flops an
// element) is far below the fp32 rate.  What a call costs is the
// launch and the chain of dependent global-memory round trips each warp
// waits through, so the design cuts that chain to two (ids and side data,
// then rows) and keeps enough warps resident to hide the instructions
// between them.  A pruned or masked lane issues no load of its row: that
// skipped read is the point of CRouting (DESIGN.md section 3).
//
// Design (the one launch form; PERF.md has the measurements behind it):
//   * one warp owns kSpan = 4 consecutive lanes of one query row, and its
//     32 threads read those lanes' rows together; the grid is
//     B x ceil(L / 4) warps in CTAs of 4 warps, and no warp ever waits for
//     another (no block barrier, no shared copy of the query).  A warp of
//     32 lanes was far slower on the H100 at the search's shapes (PERF.md):
//     it leaves 4 warps an SM, too few to hide a warp's instructions;
//   * round trip 1: lane t loads its lane's id, ed, dcq, bound2 and masks
//     and, beside them, elements 128*j + 4*t + c of the query into
//     registers; it evaluates the estimate, the prune and the range check
//     itself, and __ballot_sync gives the warp its mask of rows to fetch;
//   * round trip 2: the warp takes its lanes R = kSpan / passes at a time
//     (all 4 at d <= 128, so no slot is idle by construction); each slot
//     loads a row, its lane's or, for a lane that fetches nothing, the
//     group's first fetched row again (lines already in flight), so the R
//     loads (float4, or scalar where d % 4 != 0 or the table or queries
//     are not 16-byte aligned) issue together and the group runs with no
//     branch;
//   * each lane writes its own dist2 and prune (bool) once.
//   The side operands ed, dcq and bound2 are read through strides (a [B]
//   operand, a [B, W, M] view with a zero stride, or [B, L]), and the masks
//   as one byte (bool or int8) or not at all, so the wrapper runs no
//   tensor op before the launch.
//
// Bit-exactness with the plain PyTorch version (repro_torch/kernels/ref.py):
//   * the estimate uses __fmul_rn / __fadd_rn / __fsub_rn in the plain
//     version's order, so nvcc cannot contract it into FMAs and the prune
//     mask is bit-equal (NaN estimates never prune, as in jnp.maximum);
//   * every row keeps warp_rows.cuh's order (lane t accumulates elements
//     128*j + 4*t + c in (j, c) order without FMA contraction, then a
//     butterfly over strides 16, 8, 4, 2, 1): l2sq_rows in ref.py sums in
//     exactly this order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"
#include "warp_rows.cuh"

namespace {

using warp_rows::kFull;
using warp_rows::kPass;
using warp_rows::kWarp;
constexpr int kSpan = 4;               // lanes a warp owns
constexpr int kWarpsPerCta = 4;
constexpr int kMaxPasses = 8;          // query elements held in registers
enum { kPruneNone = 0, kPruneAll = 1, kPruneMask = 2 };

struct ExpandArgs {
  const int32_t* nbrs;
  const float* queries;
  lanes::LaneF32 ed, dcq, bound2;
  const uint8_t* eval;        // null: every lane
  const uint8_t* pe;          // read when pe_mode == kPruneMask
  const float* table;
  float* dist;
  uint8_t* prune;
  long long n_rows;
  int B, L, d, chunks, pe_mode;
  float ct;
};

// One warp owns kSpan consecutive lanes of one query row; NP passes of the
// query in registers, float4 loads when kVec.
template <int NP, bool kVec>
__global__ void __launch_bounds__(kWarpsPerCta * kWarp)
fused_expand_kernel(const ExpandArgs a) {
  const int t = threadIdx.x % kWarp;
  const int gw = blockIdx.x * kWarpsPerCta + threadIdx.x / kWarp;
  const int b = gw / a.chunks;
  if (b >= a.B) return;                                  // warp-uniform
  const int l = (gw - b * a.chunks) * kSpan + t;
  const bool live = t < kSpan && l < a.L;
  const size_t o = static_cast<size_t>(b) * a.L + l;
  const float* q = a.queries + static_cast<size_t>(b) * a.d;
  // NP covers d in one sweep but at the widest instantiation
  const bool one_sweep = NP < kMaxPasses || a.d <= NP * kPass;

  // round trip 1: side data, id and the query's elements, all in flight
  int nbr = -1;
  float e_ = 0.0f, c_ = 0.0f, b2 = 0.0f;
  bool ev = false, pe = false;
  if (live) {
    nbr = a.nbrs[o];
    e_ = a.ed.at(b, l);
    c_ = a.dcq.at(b, l);
    b2 = a.bound2.at(b, l);
    ev = a.eval == nullptr || a.eval[o] != 0;
    pe = a.pe_mode == kPruneMask ? a.pe[o] != 0 : a.pe_mode == kPruneAll;
  }
  float4 qv[NP];
  if (one_sweep) warp_rows::load_f32<NP, kVec>(qv, q, 0, a.d, t);

  const bool ok = nbr >= 0 && nbr < a.n_rows;
  const float est2 = lanes::edge_est2(e_, c_, a.ct);   // NaN stays NaN
  const bool prune = ok && pe && est2 >= b2;
  if (live) a.prune[o] = prune ? 1 : 0;
  const unsigned mask = __ballot_sync(kFull, ok && ev && !prune);

  // round trip 2: the fetched lanes' rows, every load of a group at once
  const float mine = warp_rows::l2sq_lanes<kSpan, NP, kVec>(
      mask, nbr, q, qv, one_sweep, a.table, a.d, t);
  if (live) a.dist[o] = mine;
}

// CTAs of kWarpsPerCta warps over B x ceil(L / kSpan) warps.
unsigned grid_blocks(int B, int L) {
  const long long n_warps =
      static_cast<long long>(B) * ((L + kSpan - 1) / kSpan);
  return static_cast<unsigned>((n_warps + kWarpsPerCta - 1) / kWarpsPerCta);
}

// The launch floor: no work, the kernel's grid and block.
__global__ void fused_expand_empty() {}

template <int NP>
void launch_np(const ExpandArgs& a, int vec4, cudaStream_t s) {
  const unsigned blocks = grid_blocks(a.B, a.L);
  if (vec4) {
    fused_expand_kernel<NP, true><<<blocks, kWarpsPerCta * kWarp, 0, s>>>(a);
  } else {
    fused_expand_kernel<NP, false><<<blocks, kWarpsPerCta * kWarp, 0, s>>>(a);
  }
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  `lane_strides`
// holds (stride_b, stride_w, stride_m, m) for ed, dcq and bound2 in turn
// (lanes.cuh).  `eval_mask` (bytes, may be null: every lane) and
// `prune_eligible` (bytes, read when prune_mode == 2; 0: no lane prunes,
// 1: every lane may) are [B, L] contiguous.  `vec4`: d % 4 == 0 with 16-byte aligned table and queries.
extern "C" int fused_expand_launch(
    const void* nbrs, const void* queries, const void* ed, const void* dcq,
    const void* bound2, const long long* lane_strides, const void* eval_mask,
    const void* prune_eligible, int prune_mode, const void* table,
    long long n_rows, void* dist_out, void* prune_out, int B, int L, int d,
    float cos_theta, int vec4, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (d <= 0 || prune_mode < kPruneNone || prune_mode > kPruneMask) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ExpandArgs a;
  a.nbrs = static_cast<const int32_t*>(nbrs);
  a.queries = static_cast<const float*>(queries);
  if (!lanes::make_lane(a.ed, ed, lane_strides) ||
      !lanes::make_lane(a.dcq, dcq, lane_strides + 4) ||
      !lanes::make_lane(a.bound2, bound2, lane_strides + 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.eval = static_cast<const uint8_t*>(eval_mask);
  a.pe = static_cast<const uint8_t*>(prune_eligible);
  a.table = static_cast<const float*>(table);
  a.dist = static_cast<float*>(dist_out);
  a.prune = static_cast<uint8_t*>(prune_out);
  a.n_rows = n_rows;
  a.B = B;
  a.L = L;
  a.d = d;
  a.chunks = (L + kSpan - 1) / kSpan;
  a.pe_mode = prune_mode;
  a.ct = cos_theta;
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

// An empty kernel on the grid and block a [B, L] launch takes (the launch
// floor chip_smoke.py times beside the kernel).
extern "C" int fused_expand_empty_launch(int B, int L, void* stream) {
  if (B == 0 || L == 0) return 0;
  fused_expand_empty<<<grid_blocks(B, L), kWarpsPerCta * kWarp, 0,
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
