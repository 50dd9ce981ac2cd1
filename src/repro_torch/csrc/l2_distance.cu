// l2_distance: the tiled distance matrix between queries and candidates.
//
// Replaces the Pallas TPU kernel repro.kernels.l2_distance
// (l2_distance_pallas / _dist_kernel, src/repro/kernels/l2_distance.py:53,
// pallas_call at :65, body at :26).  For q [Q, d] and x [C, d] (fp32, or
// bf16 upcast to fp32 on load) it writes out [Q, C] fp32:
//
//   mode l2:  out[i, j] = max((|q_i|^2 + |x_j|^2) - 2 * <q_i, x_j>, 0)
//   mode ip:  out[i, j] = 1 - <q_i, x_j>
//
// with every product and sum in fp32 on the CUDA cores: no TF32 and no
// tensor cores (the fp32-parity mode).  The plain PyTorch version is
// repro_torch.kernels.ref.l2_distance_ref.
//
// What bounds it on an H100: at the retrieval path's shapes, bytes.  Each
// input is read once and the output written once, 4*(Q*d + C*d + Q*C)
// bytes: [1, 1M, 128] reads 512 MB of candidates, 0.155 ms at 3.35 TB/s;
// [32, 1M, 128] adds a 128 MB output, 0.20 ms.  The product is 2*Q*C*d
// flops, which passes the byte time near Q = 64 at the fp32 rate of
// 67 TFLOP/s ([1024, 1M, 128] would be 4 ms of operations).
//
// Design (a simple SIMT tiling, right first; a tensor-core design is for a
// later change):
// * One CTA of 128 threads owns one [BM, 128] output tile.  The d axis is a
//   loop inside the CTA (the TPU's sequential third grid axis): each step
//   stages a [BM, 16] query tile and a [128, 16] candidate tile in shared
//   memory, transposed so that the inner loop reads contiguous fragments,
//   while the next step's tiles are already loading into registers.
// * Each thread holds a TM x 8 register micro-tile (rows ty*TM + m, columns
//   4*tx + c and 64 + 4*tx + c, so a quarter warp reads 128 contiguous
//   bytes of the candidate tile).
// * The row tile follows Q: BM = 16 for Q <= 16, 32 for Q <= 32, else 64.
//   At Q = 1 (the retrieval_cand shape) a 16-row tile spends 15/16 of its
//   FMAs on masked rows, but 8 FMAs per candidate element loaded keep the
//   tile under the card's 20 flops per byte, so the candidate read still
//   sets the time.
// * The norms: in l2 mode each thread sums |q|^2 and |x|^2 over the
//   fragments it already holds (the JAX wrapper computes them before the
//   product, l2_distance.py:62-63); the candidates are still read once.
//   The epilogue writes each element once.
// * Ragged edges (any Q, C, d) are masked in the kernel: rows, columns and
//   depth beyond the array load zeros and are never stored.  Offsets are
//   64-bit (Q*C passes 2^31 at Q = 2,148 for 1M candidates).
// * The tiles are ordered row tile fastest, so the row tiles of one
//   candidate tile run together and the candidates come from HBM once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTX = 16;              // thread columns
constexpr int kTY = 8;               // thread rows
constexpr int kBN = 128;             // candidate tile
constexpr int kBK = 16;              // depth step
constexpr int kTN = kBN / kTX;       // 8 columns a thread
constexpr int kPad = 4;              // keeps shared rows 16-byte aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Load a [rows, kBK] tile starting at (r0, k0) of a [R, d] row-major array
// into registers, zero outside the array.  Element e of the tile is
// (e / kBK, e % kBK): 16 consecutive threads read 16 consecutive depths.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(const T* __restrict__ a, int64_t R,
                                          int64_t d, int64_t r0, int64_t k0,
                                          float (&reg)[ROWS * kBK / kThreads]) {
#pragma unroll
  for (int s = 0; s < ROWS * kBK / kThreads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    const int64_t r = r0 + e / kBK;
    const int64_t k = k0 + e % kBK;
    reg[s] = (r < R && k < d) ? to_f32(a[r * d + k]) : 0.0f;
  }
}

template <int ROWS>
__device__ __forceinline__ void store_tile(
    float (*sm)[ROWS + kPad], const float (&reg)[ROWS * kBK / kThreads]) {
#pragma unroll
  for (int s = 0; s < ROWS * kBK / kThreads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    sm[e % kBK][e / kBK] = reg[s];
  }
}

template <typename T, int BM, bool L2>
__global__ void __launch_bounds__(kThreads)
l2_distance_kernel(const T* __restrict__ q, const T* __restrict__ x,
                   float* __restrict__ out, int64_t Q, int64_t C, int64_t d,
                   int64_t n_row_tiles) {
  constexpr int TM = BM / kTY;
  static_assert(BM * kBK % kThreads == 0, "query tile must split evenly");
  __shared__ __align__(16) float As[kBK][BM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];

  const int64_t tile = blockIdx.x;
  const int64_t r0 = (tile % n_row_tiles) * BM;
  const int64_t c0 = (tile / n_row_tiles) * kBN;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  float acc[TM][kTN];
  float qn[TM], xn[kTN];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    qn[m] = 0.0f;
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[m][n] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < kTN; ++n) xn[n] = 0.0f;

  float ra[BM * kBK / kThreads], rb[kBN * kBK / kThreads];
  load_tile<T, BM>(q, Q, d, r0, 0, ra);
  load_tile<T, kBN>(x, C, d, c0, 0, rb);

  for (int64_t k0 = 0; k0 < d; k0 += kBK) {
    __syncthreads();                 // the previous step's reads are done
    store_tile<BM>(As, ra);
    store_tile<kBN>(Bs, rb);
    __syncthreads();
    if (k0 + kBK < d) {              // next step's tiles load meanwhile
      load_tile<T, BM>(q, Q, d, r0, k0 + kBK, ra);
      load_tile<T, kBN>(x, C, d, c0, k0 + kBK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[kTN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = As[kk][ty * TM + m];
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][kBN / 2 + 4 * tx]);
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int n = 0; n < kTN; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
      }
      if (L2) {
#pragma unroll
        for (int m = 0; m < TM; ++m) qn[m] = fmaf(a[m], a[m], qn[m]);
#pragma unroll
        for (int n = 0; n < kTN; ++n) xn[n] = fmaf(b[n], b[n], xn[n]);
      }
    }
  }

  // epilogue: each element once; 16-byte stores where a 4-column chunk is
  // whole and aligned
  const bool vec = (C % 4) == 0;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int64_t r = r0 + ty * TM + m;
    if (r >= Q) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t c = c0 + h * (kBN / 2) + 4 * tx;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dot = acc[m][4 * h + j];
        if (L2) {
          const float s = (qn[m] + xn[4 * h + j]) - 2.0f * dot;
          v[j] = s < 0.0f ? 0.0f : s;          // NaN stays NaN
        } else {
          v[j] = 1.0f - dot;
        }
      }
      float* o = out + r * C + c;
      if (vec && c + 3 < C) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < C) o[j] = v[j];
      }
    }
  }
}

template <typename T, int BM>
cudaError_t launch_bm(const void* q, const void* x, void* out, int64_t Q,
                      int64_t C, int64_t d, bool l2, cudaStream_t stream) {
  const int64_t n_row = (Q + BM - 1) / BM;
  const int64_t n_col = (C + kBN - 1) / kBN;
  if (n_row * n_col > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_row * n_col));
  const T* qq = static_cast<const T*>(q);
  const T* xx = static_cast<const T*>(x);
  float* oo = static_cast<float*>(out);
  if (l2) {
    l2_distance_kernel<T, BM, true><<<grid, kThreads, 0, stream>>>(
        qq, xx, oo, Q, C, d, n_row);
  } else {
    l2_distance_kernel<T, BM, false><<<grid, kThreads, 0, stream>>>(
        qq, xx, oo, Q, C, d, n_row);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* x, void* out, int64_t Q,
                     int64_t C, int64_t d, bool l2, cudaStream_t stream) {
  if (Q <= 16) return launch_bm<T, 16>(q, x, out, Q, C, d, l2, stream);
  if (Q <= 32) return launch_bm<T, 32>(q, x, out, Q, C, d, l2, stream);
  return launch_bm<T, 64>(q, x, out, Q, C, d, l2, stream);
}

}  // namespace

// Launch on `stream`; mode 0 = l2, 1 = ip; bf16 != 0 reads bf16 inputs.
// Returns cudaGetLastError() (0 on success).
extern "C" int l2_distance_launch(const void* q, const void* x, void* out,
                                  long long Q, long long C, long long d,
                                  int mode, int bf16, void* stream) {
  if (Q == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool l2 = mode == 0;
  const cudaError_t err =
      bf16 ? launch_t<__nv_bfloat16>(q, x, out, Q, C, d, l2, s)
           : launch_t<float>(q, x, out, Q, C, d, l2, s);
  return static_cast<int>(err);
}
