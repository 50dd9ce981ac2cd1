// pool_merge: merge new candidates into each query's sorted result pool.
//
// Replaces the Pallas TPU kernel repro.kernels.pool_merge
// (pool_merge_pallas / _merge_kernel, src/repro/kernels/pool_merge.py:95,
// body at :43).  For each row b: the best P entries of the union of the
// sorted pool (pool_d/pool_i [B, P]) and the new tile (new_d/new_i [B, L]),
// ordered lexicographically by (dist, id); ties on distance go to the
// smaller id.  The engine passes id*4 + flags as the id, so the flag bits
// ride along unchanged.
//
// What bounds it on an H100: bytes ((P + L) x 8 in and P x 8 out per row,
// over 3.35 TB/s), but at the hop loop's sizes (B = 128, P + L <= 512) it is
// latency bound: one CTA per row and a __syncthreads per network stage.
//
// Design: one CTA per query row.  The row's P + L entries are loaded into
// shared memory, padded to a power of two with (+inf, INT32_MAX) so that
// the pad sorts after every real entry, +inf pool sentinels included.  A
// full bitonic sort network runs over the buffer (one compare-exchange per
// thread and stage, __syncthreads between stages), then the first P entries
// are written back.  A full sort rather than a merge-path merge: the new
// tile arrives unsorted, so it would need its own sort first, and at <= 512
// entries (4 KB) the network is 45 stages of shared-memory work.
//
// It does no arithmetic on the keys, so for inputs without NaN (and without
// a -0.0 tied with a +0.0 of the same id) the output is bit-exact with the
// plain version: a stable sort by id, then a stable sort by distance.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void pool_merge_kernel(const float* __restrict__ pool_d,
                                  const int32_t* __restrict__ pool_i,
                                  const float* __restrict__ new_d,
                                  const int32_t* __restrict__ new_i,
                                  float* __restrict__ out_d,
                                  int32_t* __restrict__ out_i,
                                  int P, int L, int net) {
  extern __shared__ unsigned char smem[];
  float* sd = reinterpret_cast<float*>(smem);
  int32_t* si = reinterpret_cast<int32_t*>(sd + net);
  const size_t b = blockIdx.x;

  for (int e = threadIdx.x; e < net; e += blockDim.x) {
    float dv = INFINITY;
    int32_t iv = INT32_MAX;
    if (e < P) {
      dv = pool_d[b * P + e];
      iv = pool_i[b * P + e];
    } else if (e < P + L) {
      dv = new_d[b * L + (e - P)];
      iv = new_i[b * L + (e - P)];
    }
    sd[e] = dv;
    si[e] = iv;
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
        const bool a_first = (da < dc) || (da == dc && ia <= ic);
        const bool up = (a & k) == 0;               // ascending block
        if (up != a_first) {
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

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `net` is
// the power of two >= P + L; shared memory is net * 8 bytes.
extern "C" int pool_merge_launch(const void* pool_d, const void* pool_i,
                                 const void* new_d, const void* new_i,
                                 void* out_d, void* out_i, int B, int P,
                                 int L, int net, void* stream) {
  if (B == 0 || P == 0) return 0;
  int threads = net / 2 < 512 ? net / 2 : 512;
  if (threads < 32) threads = 32;
  pool_merge_kernel<<<B, threads, net * 8, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pool_d), static_cast<const int32_t*>(pool_i),
      static_cast<const float*>(new_d), static_cast<const int32_t*>(new_i),
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i), P, L, net);
  return static_cast<int>(cudaGetLastError());
}
