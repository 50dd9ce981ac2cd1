// pool_merge: merge new candidates into each query's result pool.
//
// Replaces the Pallas TPU kernel repro.kernels.pool_merge
// (pool_merge_pallas / _merge_kernel, src/repro/kernels/pool_merge.py:95,
// body at :43).  For each row b: the best P entries of the union of the
// pool (pool_d/pool_i [B, P]) and the new tile (new_d/new_i [B, L]),
// ordered lexicographically by (dist, id); ties on distance go to the
// smaller id.  The engine passes id*4 + flags as the id, so the flag bits
// ride along unchanged.
//
// The pool is sorted by (dist, id) except after a stage-2 rerank: the
// two-stage path writes exact distances into pool_d in place at beam
// selection, and only the next merge restores the order.  The kernel
// therefore orders the whole union and assumes nothing of either input.
//
// What bounds it on an H100: bytes ((P + L) x 8 in and P x 8 out per row,
// over 3.35 TB/s, about 0.1 us at B = 128), but at the hop loop's sizes
// (B = 128, P + L <= 512) it is latency bound: the launch, then the
// dependent steps of the sorting network.  The earlier design (one CTA a
// row, a bitonic network in shared memory) paid a __syncthreads for each
// of its 36-45 stages.
//
// Design, net = the power of two >= P + L (at least 32):
// * net <= 512 (every shape of the search paths): one warp a row, four
//   rows a CTA, pool_merge_kernel_warp<E>.  Lane l holds entries
//   l*E .. l*E + E - 1 (E = net / 32 <= 16) in registers.  A bitonic
//   network runs over them: the stages whose stride is below E compare
//   two registers of one lane and cost no communication; the others
//   compare register r of lane l with register r of lane l ^ (stride / E)
//   through __shfl_xor_sync (at net = 256, 15 of the 36 stages).  The
//   warp's own slice of shared memory only turns the coalesced loads and
//   stores into the lane-major layout (one gap word every 32 entries keeps
//   the lanes on distinct banks), under __syncwarp.  No block barrier
//   runs: a warp whose row is past B simply returns.
// * 512 < net <= 4096: several warps a row, pool_merge_kernel_block.  The
//   row's entries live in shared memory and the bitonic network runs with
//   one compare-exchange a thread and a __syncthreads a stage.
// In both, the pad entries are (+inf, INT32_MAX), which sort after every
// real entry, +inf pool sentinels included, and the first P entries are
// written back.  The Python chooser (kernels/pool_merge.py,
// choose_variant) picks the variant; the launcher refuses a mismatch.
//
// A bitonic network is not stable, but it needs no stability: (dist, id)
// is a total order on the inputs, and two entries equal in both are
// interchangeable.  So for inputs without NaN (and without a -0.0 tied
// with a +0.0 of the same id) the output is bit-exact with the plain
// version: a stable sort by id, then a stable sort by distance.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerCta = 4;        // warps a CTA in the warp variant
constexpr int kWarpMaxNet = 512;      // 16 entries a lane
constexpr unsigned kFull = 0xffffffffu;

// (da, ia) comes first, or ties with, (dc, ic)
__device__ __forceinline__ bool before(float da, int32_t ia, float dc,
                                       int32_t ic) {
  return (da < dc) || (da == dc && ia <= ic);
}

// Entry e of the union (padded past P + L), as a predicated load from a
// selected address rather than a branch, so that a thread's loads are all
// in flight before the first one is used.
__device__ __forceinline__ void load_entry(
    const float* __restrict__ pool_d, const int32_t* __restrict__ pool_i,
    const float* __restrict__ new_d, const int32_t* __restrict__ new_i,
    int64_t b, int P, int L, int e, float& dv, int32_t& iv) {
  const bool in_pool = e < P;
  const int64_t at = in_pool ? b * P + e : b * L + (e - P);
  const float* pd = in_pool ? pool_d : new_d;
  const int32_t* pi = in_pool ? pool_i : new_i;
  const bool live = e < P + L;
  dv = live ? __ldg(pd + at) : INFINITY;
  iv = live ? __ldg(pi + at) : INT32_MAX;
}

// one gap word after every 32 entries of a warp's slice
__device__ __forceinline__ int gap(int e) { return e + (e >> 5); }

template <int LOG_E>
__global__ void __launch_bounds__(32 * kRowsPerCta)
pool_merge_kernel_warp(const float* __restrict__ pool_d,
                       const int32_t* __restrict__ pool_i,
                       const float* __restrict__ new_d,
                       const int32_t* __restrict__ new_i,
                       float* __restrict__ out_d, int32_t* __restrict__ out_i,
                       int B, int P, int L) {
  constexpr int E = 1 << LOG_E;
  constexpr int LOG_N = LOG_E + 5;
  constexpr int N = 32 * E;
  constexpr int S = N + N / 32;
  __shared__ float sd[kRowsPerCta][S];
  __shared__ int32_t si[kRowsPerCta][S];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRowsPerCta + w;
  if (b >= B) return;                   // the whole warp: no block barrier
  float* wd = sd[w];
  int32_t* wi = si[w];

  float d[E];
  int32_t id[E];
#pragma unroll
  for (int s = 0; s < E; ++s)           // coalesced, all in flight at once
    load_entry(pool_d, pool_i, new_d, new_i, b, P, L, lane + 32 * s, d[s],
               id[s]);
#pragma unroll
  for (int s = 0; s < E; ++s) {
    wd[gap(lane + 32 * s)] = d[s];
    wi[gap(lane + 32 * s)] = id[s];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < E; ++r) {
    d[r] = wd[gap(lane * E + r)];
    id[r] = wi[gap(lane * E + r)];
  }

#pragma unroll
  for (int lk = 1; lk <= LOG_N; ++lk) {
    const int k = 1 << lk;              // length of the blocks being merged
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;            // compare-exchange stride
      if (j >= E) {
        // partner: register r of lane ^ (j / E)
        const int m = j / E;
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const float od = __shfl_xor_sync(kFull, d[r], m);
          const int32_t oi = __shfl_xor_sync(kFull, id[r], m);
          // the lower slot of an ascending block (or the upper slot of a
          // descending one) keeps the first of the pair; (dist, id) is a
          // total order, so the two lanes' comparisons agree
          const bool keep_first = lower == (((lane * E + r) & k) == 0);
          const bool mine = before(d[r], id[r], od, oi) == keep_first;
          d[r] = mine ? d[r] : od;
          id[r] = mine ? id[r] : oi;
        }
      } else {
        // partner: register r | j of the same lane
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if (r & j) continue;
          const int r2 = r | j;
          const bool up = ((lane * E + r) & k) == 0;
          if (before(d[r], id[r], d[r2], id[r2]) != up) {
            const float td = d[r];
            d[r] = d[r2];
            d[r2] = td;
            const int32_t ti = id[r];
            id[r] = id[r2];
            id[r2] = ti;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < E; ++r) {
    wd[gap(lane * E + r)] = d[r];
    wi[gap(lane * E + r)] = id[r];
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < E; ++s) {         // coalesced
    const int e = lane + 32 * s;
    if (e < P) {
      out_d[b * P + e] = wd[gap(e)];
      out_i[b * P + e] = wi[gap(e)];
    }
  }
}

__global__ void pool_merge_kernel_block(const float* __restrict__ pool_d,
                                        const int32_t* __restrict__ pool_i,
                                        const float* __restrict__ new_d,
                                        const int32_t* __restrict__ new_i,
                                        float* __restrict__ out_d,
                                        int32_t* __restrict__ out_i,
                                        int P, int L, int net) {
  extern __shared__ unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);
  int32_t* si = reinterpret_cast<int32_t*>(sd + net);
  const int64_t b = blockIdx.x;

  for (int e = threadIdx.x; e < net; e += blockDim.x) {
    load_entry(pool_d, pool_i, new_d, new_i, b, P, L, e, sd[e], si[e]);
  }
  __syncthreads();

  const int half = net / 2;
  for (int k = 2; k <= net; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int a = 2 * j * (t / j) + (t % j);   // partner is a + j
        const int c = a + j;
        const float da = sd[a], dc = sd[c];
        const int32_t ia = si[a], ic = si[c];
        const bool up = (a & k) == 0;               // ascending block
        if (up != before(da, ia, dc, ic)) {
          sd[a] = dc;
          sd[c] = da;
          si[a] = ic;
          si[c] = ia;
        }
      }
      __syncthreads();
    }
  }

  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    out_d[b * P + e] = sd[e];
    out_i[b * P + e] = si[e];
  }
}

template <int LOG_E>
void launch_warp(const float* pd, const int32_t* pi, const float* nd,
                 const int32_t* ni, float* od, int32_t* oi, int B, int P,
                 int L, cudaStream_t stream) {
  const int grid = (B + kRowsPerCta - 1) / kRowsPerCta;
  pool_merge_kernel_warp<LOG_E><<<grid, 32 * kRowsPerCta, 0, stream>>>(
      pd, pi, nd, ni, od, oi, B, P, L);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a variant that does not fit the shape.  `net`
// is the power of two >= max(P + L, 32); `variant` 0 is the warp kernel
// (net <= 512), 1 the block kernel (net <= 4096, net * 8 bytes of shared
// memory).
extern "C" int pool_merge_launch(const void* pool_d, const void* pool_i,
                                 const void* new_d, const void* new_i,
                                 void* out_d, void* out_i, int B, int P,
                                 int L, int net, int variant, void* stream) {
  if (B == 0 || P == 0) return 0;
  if (net < 32 || (net & (net - 1)) != 0 || net < P + L ||
      (variant == 0 && net > kWarpMaxNet) || (variant == 1 && net > 4096) ||
      variant < 0 || variant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pd = static_cast<const float*>(pool_d);
  const int32_t* pi = static_cast<const int32_t*>(pool_i);
  const float* nd = static_cast<const float*>(new_d);
  const int32_t* ni = static_cast<const int32_t*>(new_i);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  if (variant == 0) {
    switch (net) {
      case 32: launch_warp<0>(pd, pi, nd, ni, od, oi, B, P, L, s); break;
      case 64: launch_warp<1>(pd, pi, nd, ni, od, oi, B, P, L, s); break;
      case 128: launch_warp<2>(pd, pi, nd, ni, od, oi, B, P, L, s); break;
      case 256: launch_warp<3>(pd, pi, nd, ni, od, oi, B, P, L, s); break;
      default: launch_warp<4>(pd, pi, nd, ni, od, oi, B, P, L, s); break;
    }
  } else {
    const int threads = net / 2 < 512 ? net / 2 : 512;
    pool_merge_kernel_block<<<B, threads, net * 8, s>>>(pd, pi, nd, ni, od,
                                                        oi, P, L, net);
  }
  return static_cast<int>(cudaGetLastError());
}
