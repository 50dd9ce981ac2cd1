// sq8_distance: stage 1 of the two-stage SQ8 search path.
//
// Replaces the Pallas TPU kernel repro.kernels.sq8_distance
// (sq8_distance_pallas / _sq8_kernel, src/repro/kernels/sq8_distance.py:87,
// body at :30).  For every lane (b, l) whose eval flag is set and whose id
// names a row (0 <= nbr < n_rows), dequantize the neighbour's uint8 code
// row and emit
//
//   xhat  = lo + code * scale                       (per dimension)
//   delta = q_b - xhat
//   ad2   = sum delta^2                             (the estimate)
//   lb2   = max(ad2 - 2 * sum |delta| * eps, 0)     (a true lower bound)
//
// Other lanes load nothing and write +inf to both outputs: that skipped
// code-row read is the point of the two stages (DESIGN.md section 3).
//
// What bounds it on an H100: bytes by the count, latency in fact.  The
// work per call is the code rows of the evaluated lanes (d bytes each, a
// quarter of the fp32 row) plus nbrs and eval in, ad2 and lb2 out, the
// queries and the three [d] grid arrays, under half a microsecond of
// bytes at the search's tiles, and about 8 flops an element.  What a call
// costs is the launch and the chain of dependent round trips a warp waits
// through, so the design cuts it to two, as fused_expand.cu's does.
//
// Design (the one launch form, fused_expand.cu's; PERF.md has the
// measurements behind it):
//   * one warp owns kSpan = 4 consecutive lanes of one query row, and its
//     32 threads read those lanes' code rows together; the grid is
//     B x ceil(L / 4) warps in CTAs of 4 warps, and no warp ever waits for
//     another (no block barrier, no shared copies);
//   * round trip 1: lane t loads its lane's id and eval flag (bool or int8,
//     or none: every lane) and, beside them, elements 128*j + 4*t + c of q,
//     lo, scale and eps into registers; the range check is its own, and
//     __ballot_sync gives the warp its mask of rows to fetch;
//   * round trip 2: the warp takes its lanes R = kSpan / passes at a time
//     (all 4 at d <= 128); each slot loads a code row, its lane's or the
//     group's first evaluated row again, so the R uchar4 loads (bytes where
//     d % 4 != 0 or the table is not 4-byte aligned) issue together and the
//     group runs with no branch; two partials a row (ad2 and the slack
//     sum), each reduced with the warp_rows.cuh butterfly;
//   * each lane writes its own ad2 and lb2 once.
//
// Bit-exactness with the plain PyTorch version (ref.sq8_estimate_ref):
// every product and sum uses __fmul_rn / __fadd_rn / __fsub_rn in the
// plain version's order (dequantize, difference, square or |delta| * eps,
// accumulate), the element order is warp_order_sum's, and the clamp keeps
// NaN, so ad2 and lb2 are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_rows.cuh"

namespace {

using warp_rows::kFull;
using warp_rows::kPass;
using warp_rows::kWarp;
constexpr int kSpan = 4;               // lanes a warp owns
constexpr int kWarpsPerCta = 4;
constexpr int kMaxPasses = 4;          // q, lo, scale, eps in registers

struct Sq8Args {
  const int32_t* nbrs;
  const float* queries;
  const float* lo;
  const float* scale;
  const float* eps;
  const uint8_t* eval;        // null: every lane
  const uint8_t* codes;
  float* ad2;
  float* lb2;
  long long n_rows;
  int B, L, d, chunks;
};

// The grid arrays and the query, lane t's elements of NP passes.
template <int NP, bool kVec>
struct Sq8Consts {
  float4 q[NP], lo[NP], sc[NP], eps[NP];
  __device__ __forceinline__ void load(const Sq8Args& a, const float* qrow,
                                       int base, int t) {
    warp_rows::load_f32<NP, kVec>(q, qrow, base, a.d, t);
    warp_rows::load_f32<NP, kVec>(lo, a.lo, base, a.d, t);
    warp_rows::load_f32<NP, kVec>(sc, a.scale, base, a.d, t);
    warp_rows::load_f32<NP, kVec>(eps, a.eps, base, a.d, t);
  }
};

struct Sq8Acc {
  float ad2 = 0.0f;
  float slack = 0.0f;
};

// Lane t's terms of one code row over NP passes, in (j, c) order.  Past d
// every operand is zero (load_f32 / load_u8), so those terms add exact
// zeros and need no branch.
template <int NP, bool kVec>
__device__ __forceinline__ void add_codes(Sq8Acc& a,
                                          const Sq8Consts<NP, kVec>& k,
                                          const uchar4 (&code)[NP]) {
  using warp_rows::f4_at;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float xhat = __fadd_rn(
          f4_at(k.lo[j], c),
          __fmul_rn(static_cast<float>(warp_rows::u4_at(code[j], c)),
                    f4_at(k.sc[j], c)));
      const float delta = __fsub_rn(f4_at(k.q[j], c), xhat);
      a.ad2 = __fadd_rn(a.ad2, __fmul_rn(delta, delta));
      a.slack = __fadd_rn(a.slack,
                          __fmul_rn(fabsf(delta), f4_at(k.eps[j], c)));
    }
  }
}

// Reduce R rows' partials and hand each row's (ad2, lb2) to its lane.
template <int R>
__device__ __forceinline__ void finish_rows(Sq8Acc (&acc)[R],
                                            const int (&src)[R], int t,
                                            float& ad2, float& lb2) {
  float s_ad[R], s_sl[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s_ad[r] = acc[r].ad2;
    s_sl[r] = acc[r].slack;
  }
  warp_rows::warp_sum_rows<R>(s_ad);
  warp_rows::warp_sum_rows<R>(s_sl);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (t == src[r]) {
      float lb = __fsub_rn(s_ad[r], __fmul_rn(2.0f, s_sl[r]));
      lb = lb < 0.0f ? 0.0f : lb;                        // NaN stays NaN
      ad2 = s_ad[r];
      lb2 = lb;
    }
  }
}

// One warp owns kSpan consecutive lanes of one query row; NP passes of the
// constants in registers, vector loads when kVec.
template <int NP, bool kVec>
__global__ void __launch_bounds__(kWarpsPerCta * kWarp)
sq8_distance_kernel(const Sq8Args a) {
  constexpr int R = warp_rows::rows_for(kSpan, NP);
  const int t = threadIdx.x % kWarp;
  const int gw = blockIdx.x * kWarpsPerCta + threadIdx.x / kWarp;
  const int b = gw / a.chunks;
  if (b >= a.B) return;                                  // warp-uniform
  const int l = (gw - b * a.chunks) * kSpan + t;
  const bool live = t < kSpan && l < a.L;
  const size_t o = static_cast<size_t>(b) * a.L + l;
  const float* qrow = a.queries + static_cast<size_t>(b) * a.d;
  const bool one_sweep = NP < kMaxPasses || a.d <= NP * kPass;

  // round trip 1: id, eval flag and the constants, all in flight
  int nbr = -1;
  bool ev = false;
  if (live) {
    nbr = a.nbrs[o];
    ev = a.eval == nullptr || a.eval[o] != 0;
  }
  Sq8Consts<NP, kVec> k;
  if (one_sweep) k.load(a, qrow, 0, t);
  const unsigned mask =
      __ballot_sync(kFull, ev && nbr >= 0 && nbr < a.n_rows);
  float ad2 = __int_as_float(0x7f800000);
  float lb2 = ad2;

  // round trip 2, R lanes at a time: every slot loads a code row (a lane
  // that evaluates nothing re-reads the group's first row, lines already
  // in flight), so the R loads issue together and the group runs with no
  // branch; only evaluated lanes keep their sums
#pragma unroll
  for (int g0 = 0; g0 < kSpan; g0 += R) {
    const unsigned gm = (mask >> g0) & ((1u << R) - 1u);
    if (gm == 0) continue;                               // warp-uniform
    const int first = __shfl_sync(kFull, nbr, g0 + __ffs(gm) - 1);
    int id[R], src[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int own = __shfl_sync(kFull, nbr, g0 + r);
      id[r] = (gm >> r) & 1u ? own : first;
      src[r] = (gm >> r) & 1u ? g0 + r : -1;
    }
    Sq8Acc acc[R];
    for (int base = 0; base < a.d; base += NP * kPass) {
      if (!one_sweep) k.load(a, qrow, base, t);
      uchar4 x[R][NP];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        warp_rows::load_u8<NP, kVec>(
            x[r], a.codes + static_cast<size_t>(id[r]) * a.d, base, a.d, t);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) add_codes<NP, kVec>(acc[r], k, x[r]);
    }
    finish_rows<R>(acc, src, t, ad2, lb2);
  }
  if (live) {
    a.ad2[o] = ad2;
    a.lb2[o] = lb2;
  }
}

// CTAs of kWarpsPerCta warps over B x ceil(L / kSpan) warps.
unsigned grid_blocks(int B, int L) {
  const long long n_warps =
      static_cast<long long>(B) * ((L + kSpan - 1) / kSpan);
  return static_cast<unsigned>((n_warps + kWarpsPerCta - 1) / kWarpsPerCta);
}

// The launch floor: no work, the kernel's grid and block.
__global__ void sq8_distance_empty() {}

template <int NP>
void launch_np(const Sq8Args& a, int vec4, cudaStream_t s) {
  const unsigned blocks = grid_blocks(a.B, a.L);
  if (vec4) {
    sq8_distance_kernel<NP, true><<<blocks, kWarpsPerCta * kWarp, 0, s>>>(a);
  } else {
    sq8_distance_kernel<NP, false><<<blocks, kWarpsPerCta * kWarp, 0, s>>>(a);
  }
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).  nbrs and
// eval_mask (bytes, may be null: every lane) are [B, L] contiguous.
// `vec4`: d % 4 == 0, a 4-byte aligned code table and 16-byte aligned
// queries and grid arrays.
extern "C" int sq8_distance_launch(const void* nbrs, const void* queries,
                                   const void* lo, const void* scale,
                                   const void* eps, const void* eval_mask,
                                   const void* codes, long long n_rows,
                                   void* ad2_out, void* lb2_out, int B,
                                   int L, int d, int vec4, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Sq8Args a;
  a.nbrs = static_cast<const int32_t*>(nbrs);
  a.queries = static_cast<const float*>(queries);
  a.lo = static_cast<const float*>(lo);
  a.scale = static_cast<const float*>(scale);
  a.eps = static_cast<const float*>(eps);
  a.eval = static_cast<const uint8_t*>(eval_mask);
  a.codes = static_cast<const uint8_t*>(codes);
  a.ad2 = static_cast<float*>(ad2_out);
  a.lb2 = static_cast<float*>(lb2_out);
  a.n_rows = n_rows;
  a.B = B;
  a.L = L;
  a.d = d;
  a.chunks = (L + kSpan - 1) / kSpan;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= kPass) {
    launch_np<1>(a, vec4, s);
  } else if (d <= 2 * kPass) {
    launch_np<2>(a, vec4, s);
  } else {
    launch_np<kMaxPasses>(a, vec4, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid and block a [B, L] launch takes (the launch
// floor chip_smoke.py times beside the kernel).
extern "C" int sq8_distance_empty_launch(int B, int L, void* stream) {
  if (B == 0 || L == 0) return 0;
  sq8_distance_empty<<<grid_blocks(B, L), kWarpsPerCta * kWarp, 0,
                       static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
