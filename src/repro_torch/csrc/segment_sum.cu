// segment_sum: a sum of rows by segment id, in a fixed order.
//
// Replaces no Pallas TPU kernel.  It stands where the reference sums rows
// by id with XLA's scatter-add (jax.ops.segment_sum, and the backward of
// jnp.take: src/repro/models/gnn.py:137, src/repro/models/dlrm.py:104),
// which is deterministic.  PyTorch's CUDA index_add_ and the backward of
// F.embedding add a row's duplicates in an order that changes from run to
// run, so the port's DLRM, LM and GNN gradients did not repeat bit for bit
// on the card.  This kernel is the port's one way to sum rows by id:
//
//   out[s, c] = sum of data[i, c] over seg_ids[i] == s, added in
//               increasing i, starting from +0; an empty segment is 0.
//
// That is the order of the CPU's sequential index_add_ into zeros, the
// plain version (ref.segment_sum_ref), which the kernel equals bit for bit.
// Accumulators: fp32 for fp32 data, and fp32 for bf16 data too, rounded to
// bf16 once at the end (round to nearest even), as the CPU's index_add_ of
// a 2-D bf16 tensor does; the plain version spells that out by summing in
// fp32 and casting.
//
// Set-up (the wrapper, kernels/segment_sum.py): a stable sort of the ids
// gives each segment's run of original row numbers in increasing order
// (`order`, with the sorted ids) and searchsorted gives the run offsets
// [S + 1].
//
// What bounds it on an H100: bytes by the count (each data row read once,
// the ids, the output written once: N*d*e + 8*N + S*d*e bytes at 3.35
// TB/s), but a long run is a dependent chain of adds that one warp walks
// in order, where atomics would spread it over the card: a 3-row table at
// B = 65,536 gives three runs of ~21,845 rows.  The design:
//   * a warp owns one run and 32 columns (a lane a column: a row's 32
//     columns are one coalesced load).  It reads 32 of the run's row
//     numbers at once (a lane each), hands them round with __shfl_sync and
//     issues all 32 row loads before the first add (unconditional: a lane
//     past the run or the row re-reads a valid element, which is not
//     added), and it reads the next 32 row numbers before adding.  Adds are
//     __fadd_rn, never contracted or reordered;
//   * tasks are numbered column tile first, and a CTA is two warps, so the
//     column tiles of one long run land on different SMs (each SM can keep
//     only so many loads in flight);
//   * the grid covers the segments (an empty one writes zeros) unless the
//     segments outnumber the rows by more than kRunStartRatio, as a 4M-row
//     table's gradient does at B = 65,536: then it covers the sorted
//     positions, a warp continues only at the start of a run, and the
//     launcher zeroes the output first (a warp for each empty segment is
//     what made that case slow; a warp for each sorted position is as
//     costly where the rows far outnumber the segments).  `choose_grid` in
//     kernels/segment_sum.py mirrors the rule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 2;                 // warps a CTA
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;                // rows of a run a warp loads at once
constexpr long long kRunStartRatio = 4;   // S > 4 N: a grid over run starts

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// kRunStarts: task p of a tile is sorted position p, and only the first
// position of each in-range run sums; else task p is segment p.
template <typename T, bool kRunStarts>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ data,
                   const long long* __restrict__ sorted,
                   const long long* __restrict__ order,
                   const long long* __restrict__ offsets,
                   T* __restrict__ out, long long N, long long S,
                   long long d, long long per_tile) {
  const int lane = threadIdx.x & 31;
  const long long task =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long tile = task / per_tile;
  const long long p = task - tile * per_tile;
  const long long col = tile * 32 + lane;
  if (tile * 32 >= d) return;              // whole warp: same task
  long long s, lo;
  if (kRunStarts) {
    s = sorted[p];
    if (s < 0 || s >= S || (p > 0 && sorted[p - 1] == s)) return;
    lo = p;
  } else {
    s = p;
    lo = offsets[s];
  }
  const long long hi = offsets[s + 1];
  const long long c = col < d ? col : d - 1;   // lanes past d re-read
  float acc = 0.0f;
  long long rows = lo + lane < hi ? order[lo + lane] : 0;
  for (long long base = lo; base < hi; base += kChunk) {
    const int n = static_cast<int>(hi - base < kChunk ? hi - base : kChunk);
    float v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const long long row = __shfl_sync(0xffffffffu, rows, k);
      v[k] = load_f32(data + row * d + c);
    }
    const long long ahead = base + kChunk + lane;
    rows = ahead < hi ? order[ahead] : 0;    // the next chunk's row numbers
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < n) acc = __fadd_rn(acc, v[k]);
    }
  }
  if (col < d) store(out + s * d + col, acc);
}

template <typename T>
int launch(const void* data, const void* sorted, const void* order,
           const void* offsets, void* out, long long N, long long S,
           long long d, bool run_starts, cudaStream_t stream) {
  const long long tiles = (d + 31) / 32;
  const long long per_tile = run_starts ? N : S;
  if (run_starts) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(S * d) * sizeof(T), stream);
    if (err != cudaSuccess || N == 0) return static_cast<int>(err);
  }
  const long long blocks = (tiles * per_tile + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* d_ = static_cast<const T*>(data);
  const auto* srt = static_cast<const long long*>(sorted);
  const auto* ord = static_cast<const long long*>(order);
  const auto* off = static_cast<const long long*>(offsets);
  auto* o = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (run_starts) {
    segment_sum_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        d_, srt, ord, off, o, N, S, d, per_tile);
  } else {
    segment_sum_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        d_, srt, ord, off, o, N, S, d, per_tile);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).
// data [N, d] (dtype 0: f32, 1: bf16) contiguous; sorted [N] int64, the
// ids in stable sorted order, and order [N] int64, their original row
// numbers; offsets [S + 1] int64, segment s's run is
// order[offsets[s]:offsets[s + 1]]; out [S, d] of data's dtype,
// contiguous, every element written.  grid 1 covers the run starts (and
// zeroes out first), 0 the segments; the wrapper picks it (choose_grid).
extern "C" int segment_sum_launch(const void* data, const void* sorted,
                                  const void* order, const void* offsets,
                                  void* out, long long N, long long S,
                                  long long d, int dtype, int grid,
                                  void* stream) {
  if (N < 0 || S < 0 || d < 0 || (dtype != 0 && dtype != 1) ||
      (grid != 0 && grid != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0 || d == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float>(data, sorted, order, offsets, out, N, S, d,
                             grid == 1, st)
             : launch<__nv_bfloat16>(data, sorted, order, offsets, out, N, S,
                                     d, grid == 1, st);
}

// The rule choose_grid mirrors: a grid over run starts iff S > 4 N.
extern "C" long long segment_sum_run_start_ratio() { return kRunStartRatio; }
