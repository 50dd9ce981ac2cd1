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
// a 2-D bf16 tensor does.  Adds are __fadd_rn, never contracted.
//
// Set-up (kernels/segment_sum.py `runs`, once per id list): a stable sort
// of the ids as int32 keys gives `sorted` and `order` (each segment's row
// numbers in increasing order), searchsorted the run offsets [S + 1], and
// a few small ops the list of long runs: every run of at least
// kLongRunRows rows, found at the chunk start (a multiple of kLongRunRows
// in sorted order) that falls first inside it, in increasing segment id,
// padded with S.  The list is worked out on the device: no run length is
// read back to the host.  Only the run-start grid reads `sorted`, so the
// set-up keeps it only where that grid is chosen.
//
// What bounds it on an H100.  Bytes: each data row read once, the ids and
// the output written once (N*d*e + 8*N + S*d*e bytes at 3.35 TB/s).  And,
// for a long run, its chain: the order is fixed, so a run of n rows is n
// dependent __fadd_rn a column (2.45 ns each on an H100), and no split of
// the run can shorten that.  A 3-row table's gradient at B = 65,536 is
// three runs of ~21,900 rows: ~54 us of chain against 10 us of bytes.  One launch, two parts, chosen per run on the device:
//
// * Long runs (the first long_blocks CTAs): a CTA takes one (long run,
//   32-byte column tile) item from the list, and the next one
//   long_blocks further on.  The tiles of one run are neighbouring items,
//   so one run spreads over many SMs (16 CTAs for d = 128 fp32).  The
//   run's rows stream through a ring of kStages x kRingRows tile rows in
//   shared memory filled by cp.async (16 bytes a copy where the rows allow
//   it, else 4; TMA cannot gather rows), one stage ahead of the adds; the
//   run's row numbers reach shared memory by cp.async one stage ahead of
//   the copies that need them.  One __syncthreads a stage, and each stage
//   costs a fixed part beside its adds, so stages are long: on an H100,
//   two stages of 512 rows beat six of 128 by 1.4x on a 3-row table.
//   Warps 1..7 copy; a thread a column of warp 0 adds the stage's rows
//   from shared memory in row order, its loads kAhead rows ahead of its
//   adds, and issues no copy: once the copies keep the memory pipeline
//   full, a copy instruction waits for room, and in the adding warp that
//   wait would stand before every stage's adds (measured: the copies'
//   time and the adds' time summed instead of overlapping).  The chain of
//   __fadd_rn is then the only serial part.
// * Every other run (the rest of the grid): a warp owns tasks_per_warp
//   consecutive tasks (segments, or sorted positions when segments
//   outnumber rows by more than kRunStartRatio, then only run starts sum
//   and the launcher zeroes the output first, as for a 4M-row table or a
//   vocabulary), reads their offsets and first row numbers coalesced once,
//   and splits into groups of `lanes` lanes that cover `lanes * vec`
//   columns with 16-byte vector loads (scalar where rows are not 16-byte
//   aligned).  A group takes kTasks tasks at once, loads their first rows
//   together, then walks the rest of each run: its lanes read up to one
//   row number each at once and hand them round, and it loads only the
//   rows the run has, kRowBlock at a time.  Rows wider than one group's
//   columns are split into passes, one warp each.  tasks_per_warp shrinks
//   from 32 until the grid holds kWaveWarps warps, so a few wide tasks
//   still spread over the card.  This part is bound by bytes.
//
// `plan` below is the whole rule; kernels/segment_sum.py's `plan` mirrors
// it and a gpu test holds the two equal (segment_sum_plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                   // warps a CTA
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kRunStartRatio = 4;     // S > 4 N: tasks are positions
constexpr long long kLongRunRows = 64;      // a run this long: the ring part
constexpr long long kLongCtas = 1024;       // most CTAs of the ring part
constexpr long long kWaveWarps = 4096;      // warps the short part aims at
constexpr long long kMaxSegments = 0x7ffffffeLL;   // ids are int32, S a pad
constexpr int kSector = 32;                 // bytes of a column tile
constexpr int kRingRows = 512;              // rows a ring stage
constexpr int kStages = 2;
constexpr int kAhead = 16;                  // shared loads ahead of the adds
constexpr int kTasks = 2;                   // tasks a group loads at once
constexpr int kRowBlock = 4;                // rows of a run in flight
constexpr int kRingBytes = kStages * kRingRows * (kSector + 8);

struct Plan {
  long long run_starts;      // 1: tasks are sorted positions
  long long vec;             // elements a vector load
  long long lanes;           // lanes a group
  long long passes;          // warps a task block (column passes)
  long long tasks_per_warp;
  long long task_blocks;
  long long short_blocks;
  long long copy_bytes;      // cp.async size of the ring part, 0: no ring
  long long tiles;           // 32-byte column tiles a row
  long long long_min;        // runs this long go to the ring part, 0: none
  long long long_blocks;
  long long smem_bytes;
};
constexpr int kPlanFields = 12;

__host__ __device__ inline long long cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

Plan make_plan(long long N, long long S, long long d, int e, int align) {
  Plan p;
  p.run_starts = S > kRunStartRatio * N;
  p.vec = align >= 16 ? 16 / e : 1;
  const long long nv = d / p.vec;
  p.lanes = 1;
  while (p.lanes < 32 && p.lanes < nv) p.lanes *= 2;
  p.passes = cdiv(nv, p.lanes);
  const long long tasks = p.run_starts ? N : S;
  const long long gpw = 32 / p.lanes;
  long long tw = 32;
  while (tw > gpw && cdiv(tasks, tw) * p.passes < kWaveWarps) tw /= 2;
  p.tasks_per_warp = tw;
  p.task_blocks = cdiv(tasks, tw);
  p.short_blocks = cdiv(p.task_blocks * p.passes, kWarps);
  p.copy_bytes = align >= 16 ? 16 : (align >= 4 ? 4 : 0);
  p.tiles = cdiv(d * e, kSector);
  const long long n_long = cdiv(N, kLongRunRows);
  const bool ring = p.copy_bytes > 0 && n_long > 0;
  p.long_min = ring ? kLongRunRows : 0;
  p.long_blocks = ring ? (n_long * p.tiles < kLongCtas ? n_long * p.tiles
                                                       : kLongCtas)
                       : 0;
  p.smem_bytes = ring ? kRingBytes : 0;
  return p;
}

// the largest power of two up to 16 that divides the base and the row
int alignment(const void* data, long long row_bytes) {
  const unsigned long long base = reinterpret_cast<uintptr_t>(data);
  int a = 16;
  while (a > 1 && (base % a != 0 || row_bytes % a != 0)) a /= 2;
  return a;
}

struct Args {
  const void* data;
  const int* sorted;
  const long long* order;
  const long long* offsets;
  const int* long_list;
  void* out;
  long long S, d, n_long, tasks, task_blocks, passes, tiles, long_blocks,
      long_min;
  int run_starts, lanes, tasks_per_warp, copy_bytes;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int V>
__device__ __forceinline__ void add(float (&acc)[V], const Vec<T, V>& x) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], to_f32(x.v[i]));
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&acc)[V]) {
  Vec<T, V> o;
#pragma unroll
  for (int i = 0; i < V; ++i) put(&o.v[i], acc[i]);
  *reinterpret_cast<Vec<T, V>*>(p) = o;
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// --- the short part -----------------------------------------------------
// rows k .. hi - 1 of a run added into acc by a group of `lanes` lanes
// (lane gl of it, mask gmask): the group reads up to `lanes` row numbers at
// once, a lane each, and hands them round; kRowBlock row loads in flight.
// Every lane of the group runs this, columns or none (has_col).
template <typename T, int V>
__device__ void add_rest(const Args& a, const T* __restrict__ data,
                         long long k, long long hi, long long col,
                         bool has_col, int gl, unsigned gmask,
                         float (&acc)[V]) {
  const int G = a.lanes;
  for (; k < hi; k += G) {
    const long long mine = k + gl < hi ? a.order[k + gl] : 0;
    const int m = static_cast<int>(hi - k < G ? hi - k : G);
    for (int j = 0; j < m; j += kRowBlock) {
      long long r[kRowBlock];
#pragma unroll
      for (int u = 0; u < kRowBlock; ++u)
        r[u] = __shfl_sync(gmask, mine, j + u, G);
      Vec<T, V> x[kRowBlock];
#pragma unroll
      for (int u = 0; u < kRowBlock; ++u)
        if (has_col && j + u < m) x[u] = load<T, V>(data + r[u] * a.d + col);
#pragma unroll
      for (int u = 0; u < kRowBlock; ++u)
        if (has_col && j + u < m) add<T, V>(acc, x[u]);
    }
  }
}

template <typename T, int V>
__device__ void short_part(const Args& a, long long warp) {
  const int lane = threadIdx.x & 31;
  const long long blk = warp % a.task_blocks;
  const long long pass = warp / a.task_blocks;
  const long long t = blk * a.tasks_per_warp + lane;
  // lane i describes task i of the warp: segment, run, first row, whether
  // this part writes it (a long run is the ring part's)
  long long lo = 0, first = 0;
  int s = 0, n = 0, w = 0;
  if (lane < a.tasks_per_warp && t < a.tasks) {
    if (a.run_starts) {
      const int key = a.sorted[t];
      first = a.order[t];
      if (key >= 0 && key < a.S && (t == 0 || a.sorted[t - 1] != key)) {
        s = key;
        lo = t;
        n = static_cast<int>(a.offsets[key + 1] - t);
        w = 1;
      }
    } else {
      s = static_cast<int>(t);
      lo = a.offsets[t];
      n = static_cast<int>(a.offsets[t + 1] - lo);
      w = 1;
      if (n > 0) first = a.order[lo];
    }
    if (w && a.long_min > 0 && n >= a.long_min) w = 0;
  }
  const T* __restrict__ data = static_cast<const T*>(a.data);
  T* __restrict__ out = static_cast<T*>(a.out);
  const int gpw = 32 / a.lanes;
  const int g = lane / a.lanes;
  const int gl = lane % a.lanes;
  const unsigned gmask =
      a.lanes == 32 ? kFull : ((1u << a.lanes) - 1) << (g * a.lanes);
  const long long col = (pass * a.lanes + gl) * V;
  const bool has_col = col < a.d;
  for (int r0 = 0; r0 < a.tasks_per_warp; r0 += gpw * kTasks) {
    long long qlo[kTasks], qf[kTasks];
    int qs[kTasks], qn[kTasks];
    bool qw[kTasks];
#pragma unroll
    for (int u = 0; u < kTasks; ++u) {
      const int q = r0 + u * gpw + g;
      const int src = q < a.tasks_per_warp ? q : 0;
      qs[u] = __shfl_sync(kFull, s, src);
      qn[u] = __shfl_sync(kFull, n, src);
      qlo[u] = __shfl_sync(kFull, lo, src);
      qf[u] = __shfl_sync(kFull, first, src);
      qw[u] = __shfl_sync(kFull, w, src) && q < a.tasks_per_warp;
    }
    Vec<T, V> x[kTasks];
#pragma unroll
    for (int u = 0; u < kTasks; ++u)
      if (qw[u] && qn[u] > 0 && has_col)
        x[u] = load<T, V>(data + qf[u] * a.d + col);
#pragma unroll
    for (int u = 0; u < kTasks; ++u) {
      if (!qw[u]) continue;                  // the same for a whole group
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
      if (qn[u] > 0) {
        if (has_col) add<T, V>(acc, x[u]);
        add_rest<T, V>(a, data, qlo[u] + 1, qlo[u] + qn[u], col, has_col, gl,
                       gmask, acc);
      }
      if (has_col) store<T, V>(out + static_cast<long long>(qs[u]) * a.d + col, acc);
    }
  }
}

// --- the ring part ------------------------------------------------------
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ float lds(const unsigned char* p) {
  return to_f32(*reinterpret_cast<const T*>(p));
}

// one stage's m rows of a column added in row order; a full stage keeps
// kAhead shared loads in flight ahead of the adds, a partial one loads
// kAhead at a time
template <typename T>
__device__ __forceinline__ float add_stage(const unsigned char* p, int m,
                                           float acc) {
  if (m == kRingRows) {
    float v[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) v[k] = lds<T>(p + k * kSector);
#pragma unroll
    for (int k = 0; k < kRingRows; ++k) {
      const float x = v[k % kAhead];
      if (k + kAhead < kRingRows) v[k % kAhead] = lds<T>(p + (k + kAhead) * kSector);
      acc = __fadd_rn(acc, x);
    }
  } else {                                  // the run's last stage
    int k = 0;
    for (; k + kAhead <= m; k += kAhead) {
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) v[u] = lds<T>(p + (k + u) * kSector);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; k < m; ++k) acc = __fadd_rn(acc, lds<T>(p + k * kSector));
  }
  return acc;
}

// tile t of run [lo, hi) of segment s, through the ring
template <typename T>
__device__ void ring_tile(const Args& a, long long s, long long lo,
                          long long hi, int t, unsigned char* smem) {
  unsigned char* ring = smem;
  long long* ords =
      reinterpret_cast<long long*>(smem + kStages * kRingRows * kSector);
  const int tid = threadIdx.x;
  const long long n = hi - lo;
  const long long stages = cdiv(n, kRingRows);
  const long long row_bytes = a.d * static_cast<long long>(sizeof(T));
  const long long left = row_bytes - static_cast<long long>(t) * kSector;
  const int tb = static_cast<int>(left < kSector ? left : kSector);
  const int cp = a.copy_bytes;
  const int per_row = kSector / cp;          // copy slots a ring row
  const int nw = tb / cp;                    // copies a row of this tile
  const unsigned char* src =
      static_cast<const unsigned char*>(a.data) + static_cast<long long>(t) * kSector;
  const long long* order = a.order + lo;
  // warps 1.. copy, warp 0 only adds: a copy that waits for room in the
  // memory pipeline must not hold up the adds
  const int ptid = tid - 32;
  auto rows_in = [&](long long j) {
    const long long m = n - j * kRingRows;
    return static_cast<int>(m < kRingRows ? m : kRingRows);
  };
  // stage j's rows into ring slot j % kStages, row numbers from global
  // memory (the prologue) or from the shared copy of them
  auto issue_rows = [&](long long j, bool direct) {
    if (j >= stages || ptid < 0) return;
    const int m = rows_in(j);
    const int slot = static_cast<int>(j % kStages);
    unsigned char* dst = ring + slot * kRingRows * kSector;
    const long long* ord = direct ? order + j * kRingRows : ords + slot * kRingRows;
    for (int q = ptid; q < kRingRows * per_row; q += kThreads - 32) {
      const int r = q / per_row, w = q - r * per_row;
      if (r < m && w < nw)
        cp_async(dst + r * kSector + w * cp, src + ord[r] * row_bytes + w * cp,
                 cp);
    }
  };
  auto issue_order = [&](long long j) {
    if (j >= stages || ptid < 0) return;
    const int m = rows_in(j);
    long long* dst = ords + static_cast<int>(j % kStages) * kRingRows;
    for (int q = ptid; q < m; q += kThreads - 32)
      cp_async8(dst + q, order + j * kRingRows + q);
  };
  // group g holds stage g's rows and the row numbers of stage g + kStages - 1
  for (int j = 0; j < kStages - 1; ++j) {
    issue_rows(j, true);
    issue_order(j + kStages - 1);
    cp_async_commit();
  }
  const int lane = tid & 31;
  const bool adder = tid < 32 && lane < tb / static_cast<int>(sizeof(T));
  float acc = 0.0f;
  for (long long i = 0; i < stages; ++i) {
    cp_async_wait<kStages - 2>();            // group i has landed (mine)
    __syncthreads();                         // ... everyone's; slot i-1 free
    issue_rows(i + kStages - 1, false);
    issue_order(i + 2 * kStages - 2);
    cp_async_commit();                       // empty groups keep the count
    if (adder)
      acc = add_stage<T>(ring + static_cast<int>(i % kStages) * kRingRows * kSector +
                             lane * sizeof(T),
                         rows_in(i), acc);
  }
  cp_async_wait<0>();
  if (adder)
    put(static_cast<T*>(a.out) + s * a.d + static_cast<long long>(t) * (kSector / sizeof(T)) + lane,
        acc);
}

template <typename T>
__device__ void ring_part(const Args& a, long long b) {
  extern __shared__ __align__(16) unsigned char smem[];
  for (long long item = b;; item += a.long_blocks) {
    const long long k = item / a.tiles;
    if (k >= a.n_long) return;
    const long long s = a.long_list[k];
    if (s < 0 || s >= a.S) return;           // the list's padding: done
    ring_tile<T>(a, s, a.offsets[s], a.offsets[s + 1],
                 static_cast<int>(item - k * a.tiles), smem);
    __syncthreads();                         // the ring is reused
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const Args a) {
  if (blockIdx.x < a.long_blocks) {
    ring_part<T>(a, blockIdx.x);
    return;
  }
  const long long warp =
      (static_cast<long long>(blockIdx.x) - a.long_blocks) * kWarps +
      (threadIdx.x >> 5);
  if (warp < a.task_blocks * a.passes) short_part<T, V>(a, warp);
}

// one thread, n dependent adds: the card's dependent fp32 add time
__global__ void add_chain_kernel(float* out, long long n, float x) {
  float acc = 0.0f;
#pragma unroll 8
  for (long long i = 0; i < n; ++i) acc = __fadd_rn(acc, x);
  *out = acc;
}

template <typename T, int V>
cudaError_t launch(const Args& a, long long blocks, long long smem,
                   cudaStream_t stream) {
  segment_sum_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads,
                             static_cast<size_t>(smem), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns a cudaError_t (0 on success).
// data [N, d] (dtype 0: f32, 1: bf16) contiguous; sorted [N] int32, the
// ids in stable sorted order (out-of-range ids anywhere outside [0, S)),
// read only where S > 4 N (null allowed elsewhere); order [N] int64,
// their original row numbers; offsets [S + 1] int64,
// segment s's run is order[offsets[s]:offsets[s + 1]]; long_list
// [n_long = ceil(N / 64)] int32, the segments whose runs have at least 64
// rows in increasing order, padded with S; out [S, d] of data's dtype,
// contiguous, every element written.  N < 2^31, S <= 2^31 - 2.
extern "C" int segment_sum_launch(const void* data, const void* sorted,
                                  const void* order, const void* offsets,
                                  const void* long_list, long long n_long,
                                  void* out, long long N, long long S,
                                  long long d, int dtype, void* stream) {
  if (N < 0 || N > 0x7fffffffLL || S < 0 || S > kMaxSegments || d < 0 ||
      (dtype != 0 && dtype != 1) || n_long != cdiv(N, kLongRunRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0 || d == 0) return 0;
  const int e = dtype == 0 ? 4 : 2;
  const Plan p = make_plan(N, S, d, e, alignment(data, d * e));
  if (p.run_starts && N > 0 && sorted == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (p.run_starts) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(S * d) * e, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = p.long_blocks + p.short_blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.data = data;
  a.sorted = static_cast<const int*>(sorted);
  a.order = static_cast<const long long*>(order);
  a.offsets = static_cast<const long long*>(offsets);
  a.long_list = static_cast<const int*>(long_list);
  a.out = out;
  a.S = S;
  a.d = d;
  a.n_long = n_long;
  a.tasks = p.run_starts ? N : S;
  a.task_blocks = p.task_blocks;
  a.passes = p.passes;
  a.tiles = p.tiles;
  a.long_blocks = p.long_blocks;
  a.long_min = p.long_min;
  a.run_starts = static_cast<int>(p.run_starts);
  a.lanes = static_cast<int>(p.lanes);
  a.tasks_per_warp = static_cast<int>(p.tasks_per_warp);
  a.copy_bytes = static_cast<int>(p.copy_bytes);
  cudaError_t err;
  if (dtype == 0) {
    err = p.vec > 1 ? launch<float, 4>(a, blocks, p.smem_bytes, st)
                    : launch<float, 1>(a, blocks, p.smem_bytes, st);
  } else {
    err = p.vec > 1 ? launch<__nv_bfloat16, 8>(a, blocks, p.smem_bytes, st)
                    : launch<__nv_bfloat16, 1>(a, blocks, p.smem_bytes, st);
  }
  return static_cast<int>(err);
}

// The launcher's plan for these arguments (`align`: the largest power of
// two up to 16 dividing data's address and its row bytes), as kPlanFields
// numbers in Plan's order; kernels/segment_sum.py's `plan` mirrors it.
extern "C" int segment_sum_plan(long long N, long long S, long long d,
                                int dtype, int align, long long* out) {
  if (N < 0 || S < 0 || d <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(N, S, d, dtype == 0 ? 4 : 2, align);
  const long long f[kPlanFields] = {
      p.run_starts, p.vec,         p.lanes,      p.passes,
      p.tasks_per_warp, p.task_blocks, p.short_blocks, p.copy_bytes,
      p.tiles,      p.long_min,    p.long_blocks, p.smem_bytes};
  for (int i = 0; i < kPlanFields; ++i) out[i] = f[i];
  return 0;
}


// n dependent __fadd_rn of x in one thread, the sum into out[0] (fp32).
extern "C" int segment_sum_add_chain(void* out, long long n, float x,
                                     void* stream) {
  add_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n, x);
  return static_cast<int>(cudaGetLastError());
}
