// crouting_prune: the CRouting edge-angle estimate and prune decision.
//
// Replaces the Pallas TPU kernel repro.kernels.crouting_prune
// (crouting_prune_pallas / _prune_kernel,
// src/repro/kernels/crouting_prune.py:54, body at :26).  Elementwise over a
// [B, M] tile of the unfused engine:
//
//   est2  = max((ed*ed + dcq*dcq) - ((2*ed)*dcq)*ct, 0)
//   prune = valid && est2 >= bound2
//
// It reads no vector data: that is the point of CRouting.
//
// What bounds it on an H100: bytes (ed, dcq, bound2 4 bytes and valid 1
// byte in, est2 4 bytes and prune 1 byte out: 18 bytes a lane, over
// 3.35 TB/s) against 7 flops a lane.  At the hop loop's sizes (B*M = 16k
// to 32k lanes) it is one short wave of blocks: launch latency, not bytes.
//
// Design: one thread per lane, 256 threads a block, coalesced loads.
//
// Bit-exactness with the plain PyTorch version (ref.crouting_prune_ref,
// ref.edge_angle_est2): the estimate uses __fmul_rn / __fadd_rn /
// __fsub_rn in the plain version's order, so nvcc cannot contract it into
// FMAs (fused_expand.cu computes the same expression the same way); est2
// and the prune mask are bit-equal.  A NaN estimate (an inf edge length
// against a zero query distance) compares false and never prunes, as with
// jnp.maximum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
crouting_prune_kernel(const float* __restrict__ ed,
                      const float* __restrict__ dcq,
                      const float* __restrict__ bound2,
                      const int8_t* __restrict__ valid,
                      float* __restrict__ est_out,
                      int8_t* __restrict__ prune_out, int64_t n, float ct) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float e_ = ed[i];
  const float c_ = dcq[i];
  float est2 = __fsub_rn(__fadd_rn(__fmul_rn(e_, e_), __fmul_rn(c_, c_)),
                         __fmul_rn(__fmul_rn(__fmul_rn(2.0f, e_), c_), ct));
  est2 = est2 < 0.0f ? 0.0f : est2;          // NaN stays NaN
  est_out[i] = est2;
  prune_out[i] = (valid[i] != 0 && est2 >= bound2[i]) ? 1 : 0;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int crouting_prune_launch(const void* ed, const void* dcq,
                                     const void* bound2, const void* valid,
                                     void* est_out, void* prune_out,
                                     long long n, float cos_theta,
                                     void* stream) {
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  crouting_prune_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ed), static_cast<const float*>(dcq),
      static_cast<const float*>(bound2), static_cast<const int8_t*>(valid),
      static_cast<float*>(est_out), static_cast<int8_t*>(prune_out),
      static_cast<int64_t>(n), cos_theta);
  return static_cast<int>(cudaGetLastError());
}
