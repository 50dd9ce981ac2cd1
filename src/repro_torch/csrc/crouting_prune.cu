// crouting_prune: the CRouting edge-angle estimate and prune decision.
//
// Replaces the Pallas TPU kernel repro.kernels.crouting_prune
// (crouting_prune_pallas / _prune_kernel,
// src/repro/kernels/crouting_prune.py:54, body at :26).  Elementwise over
// a [B, L] tile of the unfused engine:
//
//   est2  = max((ed*ed + dcq*dcq) - ((2*ed)*dcq)*ct, 0)
//   prune = valid && est2 >= bound2
//
// It reads no vector data: that is the point of CRouting.
//
// What bounds it on an H100: bytes by the count (ed, dcq and bound2 as
// handed over, valid 1 byte a lane in, est2 4 bytes and prune 1 byte a
// lane out: a few hundred KB at the hop loop's B*L = 16k to 32k lanes,
// against 7 flops a lane), the launch in fact: it is one short wave of
// CTAs, so a call costs an empty kernel on the same grid and one
// dependent round trip to L2 (its operands were just written).
//
// Design: one thread a lane, in as few CTAs as one wave allows (256
// threads: 64 to 128 CTAs at the search's tiles), since a launch-bound
// kernel pays for each CTA it starts (a (B, L / 128) grid of 128-thread
// CTAs was slower on the H100); a thread finds its (b, l) with a shift
// when L is a power of two.  Everything that used to run around
// the kernel is the kernel's, so a call is one launch with no tensor op
// before it:
//   * ed, dcq and bound2 are read through their strides (lanes.cuh): a
//     [B] operand broadcast over the lanes, [B, L] of any strides (e.g.
//     the l2 engine's bound2, a [B] bound expanded over L), or [B, W, M]
//     with W*M = L (the engine's dcq, a [B, W] tensor expanded over M with
//     a zero stride);
//   * valid is read as one byte (bool, int8 or uint8), != 0;
//   * prune is written as a bool byte and est2 as f32.
//
// Bit-exactness with the plain PyTorch version (ref.crouting_prune_ref,
// ref.edge_angle_est2): lanes.cuh's edge_est2 keeps the plain version's
// order uncontracted (fused_expand.cu computes the same expression the
// same way); est2 and the prune mask are bit-equal.  A NaN estimate (an
// inf edge length against a zero query distance) compares false and never
// prunes, as with jnp.maximum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 256;

struct PruneArgs {
  lanes::LaneF32 ed, dcq, bound2;
  const uint8_t* valid;
  float* est;
  uint8_t* prune;
  int n, L, l_shift;           // l_shift = log2(L) when L is a power of two
  float ct;
};

__global__ void __launch_bounds__(kThreads)
crouting_prune_kernel(const PruneArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int b = a.l_shift >= 0 ? i >> a.l_shift : i / a.L;
  const int l = i - b * a.L;
  const float e_ = a.ed.at(b, l);
  const float c_ = a.dcq.at(b, l);
  const float b2 = a.bound2.at(b, l);
  const bool v = a.valid[i] != 0;
  const float est2 = lanes::edge_est2(e_, c_, a.ct);    // NaN stays NaN
  a.est[i] = est2;
  a.prune[i] = (v && est2 >= b2) ? 1 : 0;
}

// The launch floor: no work, the kernel's grid and block.
__global__ void crouting_prune_empty() {}

unsigned grid_blocks(int n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// B*L lanes numbered with an int.
bool lanes_fit(int B, int L) {
  return B >= 0 && L >= 0 &&
         static_cast<long long>(B) * L <= 0x7fffffffLL - kThreads;
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).
// `lane_strides` holds (stride_b, stride_w, stride_m, m) for ed, dcq and
// bound2 in turn (lanes.cuh); valid (bytes), est_out (f32) and prune_out
// (bool bytes) are [B, L] contiguous; cos_theta is f32.
extern "C" int crouting_prune_launch(const void* ed, const void* dcq,
                                     const void* bound2,
                                     const long long* lane_strides,
                                     const void* valid, void* est_out,
                                     void* prune_out, int B, int L,
                                     float cos_theta, void* stream) {
  if (!lanes_fit(B, L)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || L == 0) return 0;
  PruneArgs a;
  if (!lanes::make_lane(a.ed, ed, lane_strides) ||
      !lanes::make_lane(a.dcq, dcq, lane_strides + 4) ||
      !lanes::make_lane(a.bound2, bound2, lane_strides + 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.valid = static_cast<const uint8_t*>(valid);
  a.est = static_cast<float*>(est_out);
  a.prune = static_cast<uint8_t*>(prune_out);
  a.n = B * L;
  a.L = L;
  a.l_shift = lanes::log2_or_minus1(L);
  a.ct = cos_theta;
  crouting_prune_kernel<<<grid_blocks(a.n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the grid and block a [B, L] launch takes (the launch
// floor chip_smoke.py times beside the kernel).
extern "C" int crouting_prune_empty_launch(int B, int L, void* stream) {
  if (!lanes_fit(B, L)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || L == 0) return 0;
  crouting_prune_empty<<<grid_blocks(B * L), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
