// l2_distance: the distance matrix between queries and candidates.
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
// Two kernels, chosen by shape in kernels/l2_distance.py (choose_variant):
//
// l2_distance_kernel_stream, for Q <= 4 at any C and for Q <= 16 when
// C >= 4096 * Q, when the candidate rows are 16-byte aligned (x's base and
// d * sizeof(T) both multiples of 16) and the query rows fit shared
// memory.  The split is measured on the H100 (ip [Q, C, 128]): at C = 1M
// the streaming kernel beats the tiled one at every Q up to 16 (0.182
// against 0.292 ms at Q = 1, 0.264 against 0.323 ms at Q = 16), but at
// small C the grid holds fewer tiles than the card has SMs and each CTA's
// Q dot products a row set the time: at [8, 8192, 128] it takes 9.9
// against the tiled kernel's 9.4 us, at [12, 32768, 128] 17.5 against 14.7
// (device time, L2 flushed; PERF.md, chip_smoke.py's l2_crossover), so
// from Q = 5 the shapes below C = 4096 * Q keep the tiled kernel.  The launcher refuses a shape outside its
// limits (kMaxStreamQ, kMaxQueryBytes, alignment) and reports them through
// l2_distance_stream_limits, so the chooser cannot drift from it.  At small
// Q the whole cost is streaming x once, so the design keeps as many
// candidate bytes in flight as the SM can hold and spends no work on rows
// that do not exist:
// * A persistent grid (as many 128-thread CTAs as fit an SM, times the
//   SMs) walks 128-row candidate tiles; each tile is cut into 128-byte
//   column chunks (32 fp32 or 64 bf16 values a row).  A ring of kStages
//   chunks in shared memory is filled by 16-byte cp.async.cg copies (L2
//   only: the candidates are read once), kStages - 1 chunks ahead of the
//   one being reduced, with one __syncthreads a chunk.  Rows past C and
//   columns past d are zero-filled by the copy (src-size 0).
// * Each thread owns one candidate row of the tile: it reads its row's
//   chunk from shared memory as eight 16-byte loads (a row pitch of 144
//   bytes puts the 8 threads of a quarter-warp on distinct banks) and
//   the Q query rows, held in shared memory as fp32, as broadcast loads.
//   So a row's dot products need no cross-lane reduction at all, and the
//   kernel is instantiated for each Q up to kMaxStreamQ, so that no FMA is
//   spent on a masked query row.
// * l2 mode sums |x|^2 from the values it already holds; |q|^2 is summed
//   once a CTA.  The epilogue gathers four rows into one lane with
//   __shfl_sync and writes each query's 32 outputs of a warp as eight
//   16-byte stores where C % 4 == 0 (scalar stores at the ragged edge).
//
// l2_distance_kernel_tiled, for larger Q (and unaligned rows at small Q):
// * One CTA of 128 threads owns one [BM, 128] output tile.  The d axis is a
//   loop inside the CTA (the TPU's sequential third grid axis): each step
//   stages a [BM, 16] query tile and a [128, 16] candidate tile in shared
//   memory, transposed so that the inner loop reads contiguous fragments,
//   while the next step's tiles are already loading into registers.
// * Each thread holds a TM x 8 register micro-tile (rows ty*TM + m, columns
//   4*tx + c and 64 + 4*tx + c, so a quarter warp reads 128 contiguous
//   bytes of the candidate tile).  BM = 16 for Q <= 16, 32 for Q <= 32,
//   else 64.  At Q = 32 it beats cuBLAS's fp32 GEMM (PERF.md).
// * The norms: in l2 mode each thread sums |q|^2 and |x|^2 over the
//   fragments it already holds (the JAX wrapper computes them before the
//   product, l2_distance.py:62-63); the candidates are still read once.
// * The tiles are ordered row tile fastest, so the row tiles of one
//   candidate tile run together and the candidates come from HBM once.
// Both mask their ragged edges (any Q, C, d) in the kernel and use 64-bit
// offsets (Q*C passes 2^31 at Q = 2,148 for 1M candidates).

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
l2_distance_kernel_tiled(const T* __restrict__ q, const T* __restrict__ x,
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

// --- the streaming kernel for small Q ----------------------------------------
constexpr int kSRows = 128;                  // rows a tile = threads a CTA
constexpr int kChunk = 128;                  // bytes of a row a ring stage
constexpr int kPitch = kChunk + 16;          // shared row pitch (banks)
constexpr int kStages = 4;
constexpr int kStageBytes = kSRows * kPitch; // 18,432
constexpr int kMaxStreamQ = 16;
constexpr int kMaxQueryBytes = 64 * 1024;    // fp32 query rows, padded

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the values of one 16-byte piece, as fp32
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    f[2 * h] = __uint_as_float(w[h] << 16);          // low bf16
    f[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
  }
}

template <typename T, int NQ, bool L2>
__global__ void __launch_bounds__(kSRows)
l2_distance_kernel_stream(const T* __restrict__ q, const T* __restrict__ x,
                          float* __restrict__ out, int64_t C, int64_t d,
                          int64_t n_tiles) {
  constexpr int VPP = 16 / static_cast<int>(sizeof(T));   // values a piece
  constexpr int KC = kChunk / static_cast<int>(sizeof(T)); // columns a chunk
  constexpr int PIECES = kChunk / 16;                       // 8 a row
  extern __shared__ __align__(16) unsigned char smem[];
  const int nk = static_cast<int>((d + KC - 1) / KC);
  const int dq = nk * KC;                    // query pitch, zero past d
  float* qs = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  float* qn = qs + NQ * dq;                  // |q_i|^2
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  const int64_t my_tiles =
      n_tiles > blockIdx.x ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int64_t n_items = my_tiles * nk;     // (tile, chunk) in order

  auto issue = [&](int64_t s) {
    if (s < n_items) {
      const int64_t tile = blockIdx.x + (s / nk) * gridDim.x;
      const int64_t k0 = (s % nk) * KC;
      unsigned char* st = smem + (s % kStages) * kStageBytes;
#pragma unroll
      for (int j = 0; j < kSRows * PIECES / kSRows; ++j) {
        const int e = tid + j * kSRows;
        const int rr = e / PIECES, pc = e % PIECES;
        const int64_t r = tile * kSRows + rr;
        const int64_t col = k0 + pc * VPP;
        const bool in = r < C && col < d;
        cp_async16(st + rr * kPitch + pc * 16, in ? x + r * d + col : x,
                   in ? 16 : 0);
      }
    }
    cp_async_commit();                       // empty groups keep the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int e = tid; e < NQ * dq; e += kSRows) {
    const int i = e / dq, k = e % dq;
    qs[e] = k < d ? to_f32(q[i * d + k]) : 0.0f;
  }
  __syncthreads();
  if (L2) {
    for (int i = warp; i < NQ; i += kSRows / 32) {
      float sum = 0.0f;
      for (int k = lane; k < dq; k += 32) sum = fmaf(qs[i * dq + k],
                                                     qs[i * dq + k], sum);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) qn[i] = sum;
    }
  }                                          // visible after the loop's sync

  float acc[NQ];
  float xn = 0.0f;
  for (int64_t s = 0; s < n_items; ++s) {
    cp_async_wait<kStages - 2>();            // chunk s has landed (mine)
    __syncthreads();                         // (everyone's); s - 1 is done
    issue(s + kStages - 1);                  // into the stage of s - 1
    const int kc = static_cast<int>(s % nk);
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) acc[i] = 0.0f;
      xn = 0.0f;
    }
    const unsigned char* row =
        smem + (s % kStages) * kStageBytes + tid * kPitch;
    const float* qk = qs + kc * KC;
#pragma unroll
    for (int pc = 0; pc < PIECES; ++pc) {
      float xv[VPP];
      unpack(*reinterpret_cast<const uint4*>(row + pc * 16), xv);
      if (L2) {
#pragma unroll
        for (int v = 0; v < VPP; ++v) xn = fmaf(xv[v], xv[v], xn);
      }
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const float* qp = qk + i * dq + pc * VPP;
#pragma unroll
        for (int h = 0; h < VPP; h += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qp + h);
          acc[i] = fmaf(a.x, xv[h], acc[i]);
          acc[i] = fmaf(a.y, xv[h + 1], acc[i]);
          acc[i] = fmaf(a.z, xv[h + 2], acc[i]);
          acc[i] = fmaf(a.w, xv[h + 3], acc[i]);
        }
      }
    }
    if (kc == nk - 1) {                      // the tile's epilogue
      const int64_t tile = blockIdx.x + (s / nk) * gridDim.x;
      const int64_t rw = tile * kSRows + (tid & ~31);   // the warp's rows
      const bool vec = (C % 4) == 0 && rw + 32 <= C;     // warp-uniform
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        float v;
        if (L2) {
          const float t = (qn[i] + xn) - 2.0f * acc[i];
          v = t < 0.0f ? 0.0f : t;                       // NaN stays NaN
        } else {
          v = 1.0f - acc[i];
        }
        float* o = out + i * C + rw;
        if (vec) {
          const int src = 4 * (lane & 7);
          float4 w;
          w.x = __shfl_sync(0xffffffffu, v, src);
          w.y = __shfl_sync(0xffffffffu, v, src + 1);
          w.z = __shfl_sync(0xffffffffu, v, src + 2);
          w.w = __shfl_sync(0xffffffffu, v, src + 3);
          if (lane < 8) *reinterpret_cast<float4*>(o + 4 * lane) = w;
        } else if (rw + lane < C) {
          o[lane] = v;
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T, int NQ, bool L2>
cudaError_t launch_stream_q(const void* q, const void* x, void* out,
                            int64_t C, int64_t d, cudaStream_t stream) {
  constexpr int KC = kChunk / static_cast<int>(sizeof(T));
  const int64_t nk = (d + KC - 1) / KC;
  const size_t smem = static_cast<size_t>(kStages) * kStageBytes +
                      (static_cast<size_t>(NQ) * nk * KC + NQ) * sizeof(float);
  auto kern = l2_distance_kernel_stream<T, NQ, L2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kSRows, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t n_tiles = (C + kSRows - 1) / kSRows;
  const int64_t grid = n_tiles < int64_t(sms) * per_sm ? n_tiles
                                                        : int64_t(sms) * per_sm;
  kern<<<static_cast<unsigned>(grid), kSRows, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x),
      static_cast<float*>(out), C, d, n_tiles);
  return cudaGetLastError();
}

template <typename T, bool L2, int NQ = 1>
cudaError_t launch_stream(const void* q, const void* x, void* out, int64_t Q,
                          int64_t C, int64_t d, cudaStream_t stream) {
  if constexpr (NQ > kMaxStreamQ) {
    return cudaErrorInvalidValue;
  } else {
    if (Q == NQ) return launch_stream_q<T, NQ, L2>(q, x, out, C, d, stream);
    return launch_stream<T, L2, NQ + 1>(q, x, out, Q, C, d, stream);
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
    l2_distance_kernel_tiled<T, BM, true><<<grid, kThreads, 0, stream>>>(
        qq, xx, oo, Q, C, d, n_row);
  } else {
    l2_distance_kernel_tiled<T, BM, false><<<grid, kThreads, 0, stream>>>(
        qq, xx, oo, Q, C, d, n_row);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* x, void* out, int64_t Q,
                     int64_t C, int64_t d, bool l2, bool stream_kernel,
                     cudaStream_t stream) {
  if (stream_kernel) {
    // 16-byte rows: cp.async copies whole 16-byte pieces; the query rows,
    // padded to whole chunks, sit in shared memory as fp32
    constexpr int64_t KC = kChunk / static_cast<int64_t>(sizeof(T));
    if (Q > kMaxStreamQ || (d * sizeof(T)) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        Q * ((d + KC - 1) / KC) * KC * 4 > kMaxQueryBytes)
      return cudaErrorInvalidValue;
    return l2 ? launch_stream<T, true>(q, x, out, Q, C, d, stream)
              : launch_stream<T, false>(q, x, out, Q, C, d, stream);
  }
  if (Q <= 16) return launch_bm<T, 16>(q, x, out, Q, C, d, l2, stream);
  if (Q <= 32) return launch_bm<T, 32>(q, x, out, Q, C, d, l2, stream);
  return launch_bm<T, 64>(q, x, out, Q, C, d, l2, stream);
}

}  // namespace

// Launch on `stream`; mode 0 = l2, 1 = ip; bf16 != 0 reads bf16 inputs;
// variant 0 = the tiled kernel, 1 = the streaming kernel (within the limits
// that l2_distance_stream_limits reports, else cudaErrorInvalidValue).
// Returns cudaGetLastError() (0 on success).
extern "C" int l2_distance_launch(const void* q, const void* x, void* out,
                                  long long Q, long long C, long long d,
                                  int mode, int bf16, int variant,
                                  void* stream) {
  if (Q == 0 || C == 0) return 0;
  if (variant < 0 || variant > 1 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool l2 = mode == 0;
  const cudaError_t err =
      bf16 ? launch_t<__nv_bfloat16>(q, x, out, Q, C, d, l2, variant == 1, s)
           : launch_t<float>(q, x, out, Q, C, d, l2, variant == 1, s);
  return static_cast<int>(err);
}

// The streaming kernel's limits, for the Python chooser to check its own
// copy against: limits[0] the most queries, limits[1] the bytes of a row a
// chunk (d is padded to whole chunks), limits[2] the most bytes of padded
// fp32 query rows.
extern "C" void l2_distance_stream_limits(int* limits) {
  limits[0] = kMaxStreamQ;
  limits[1] = kChunk;
  limits[2] = kMaxQueryBytes;
}
