// K7: segmented reduce of sum/prod/min/max columns over int32 segment ids,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/segred_pallas.py:89 (_build, driven by
// segmented :134).  The TPU kernel keeps the values and ids in VMEM and, per
// 128-segment output tile, builds the (128, n) membership mask and reduces
// along it: O(n * nseg / 128) work, which is why it capped n at 2^15.  Here
// the work is O(n) for any n, and every eligible monoid is order-free at the
// bit level, so neither the order of the folds nor that of the atomics
// changes the result:
//
//   * every column folds signed 32-bit keys.  An integer value widens to
//     int32 (sum and product wrap modulo 2^32, as unsigned arithmetic, and
//     the result narrows back modulo the column's width, which keeps the low
//     bits of the wrapped sum or product); a bool is 0 or 1 (its sum and
//     product arrive here as max and min: "any" and "all"); a float (f16/bf16
//     widened exactly to f32) maps its bits b to
//     b ^ ((b >> 31) & 0x7FFFFFFF), which orders floats as integers order,
//     -0.0 (key -1) below +0.0 (key 0).  A NaN maps to INT_MIN for min and
//     INT_MAX for max, past every other key, so the fold itself carries the
//     NaN flag and the result propagates NaN, as XLA's min/max do.
//
// Loads: values and ids are read 16 bytes at a time (four f32 or int32,
// eight 16-bit, sixteen 8-bit values; four ids).  A column may start
// anywhere (reduce passes row slices), so a scalar head runs up to its
// first 128-byte boundary (where a warp's 512-byte load covers whole
// cache lines) and a scalar tail covers what is left after the last whole
// vector; the ids are read as vectors where they are 16-byte aligned at
// the same element, else one by one.  Each column gets its own blocks
// (blockIdx.y), its loop compiled for the column's dtype.
//
// Routes and launches per call (the wrapper's workspace: a ticket, a zeroed
// key table and a partials area, one per device and stream, so calls on
// two streams never share one):
//   * segid == null (reduce's one segment): one launch, no table and no
//     atomics.  Each thread folds in registers, each warp with shuffles,
//     each block writes one partial per column; the last block, found with
//     __threadfence() and an atomic ticket, folds the partials, writes the
//     outputs (identity past segment 0) and resets the ticket.
//   * few segments (blocks * nseg * ncols <= 2^15 partials): one launch.
//     Each block folds its elements into a shared-memory table of nseg
//     keys (a thread keeps a run of elements that share a segment in a
//     register and flushes it at a change, so sorted ids cost one shared
//     atomic a run) and writes the table to the partials; the last block
//     folds the tables and writes the outputs.  No global atomics.
//   * more segments: two launches.  The tables are flushed into the key
//     table with global atomics, then a second kernel decodes it and
//     zeroes it again.  Where there are fewer elements than the blocks'
//     tables have entries to clear and scan (n < blocks * nseg), the
//     first kernel keeps no table: each thread's runs go straight into the
//     key table.  The global keys are held as offsets from the monoid's
//     identity (sum k, product k - 1, min identity - k, max k - identity,
//     the last two as unsigned maxima), so their identity is 0 for every
//     column and no launch has to set it: the table is zero when the
//     wrapper makes it and after every call.
// SM count, shared memory per SM, the accumulating kernel's registers and
// its shared-memory limit are found once per device and kept.
//
// Bound on the H100: it reads each value (and id) once and writes nseg
// results, a few integer operations per element, so it is bytes-bound at
// 3.35 TB/s for large n.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COLS = 4;
constexpr int MAX_SEGMENTS = 1 << 15;
// the workspace: the ticket (padded to 128 bytes), the zeroed key table
// of MAX_COLS * MAX_SEGMENTS keys, then PARTIALS ints of block partials
constexpr int TICKET_INTS = 32;
constexpr int PARTIALS = 1 << 15;
enum { F32 = 0, F16 = 1, BF16 = 2, I32 = 3, I8 = 4, U8 = 5, I16 = 6, BOOL = 7 };
enum { SUM = 0, PROD = 1, MIN = 2, MAX = 3 };

// Passed to the kernels as const __grid_constant__ parameters: indexing
// them by the column (blockIdx.y) then reads the parameter space instead
// of a per-thread copy in local memory.
struct Cols {
  const void* vals[MAX_COLS];
  void* outs[MAX_COLS];
  int dtype[MAX_COLS];
  int op[MAX_COLS];
  int head[MAX_COLS];     // elements before the first 128-byte boundary
  int ids_vec[MAX_COLS];  // the ids are 16-byte aligned at that element
};

__host__ __device__ constexpr int elem_size(int dt) {
  return dt == F32 || dt == I32 ? 4 : dt == F16 || dt == BF16 || dt == I16
                                          ? 2
                                          : 1;
}

__device__ __forceinline__ int float_key(float f, int op) {
  if (f != f) return op == MIN ? INT_MIN : INT_MAX;
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

// the key of one element's bits (the low elem_size bytes of b)
template <int DT>
__device__ __forceinline__ int bits_key(unsigned b, int op) {
  if constexpr (DT == F32) return float_key(__uint_as_float(b), op);
  if constexpr (DT == F16)
    return float_key(__half2float(__ushort_as_half((unsigned short)b)), op);
  if constexpr (DT == BF16)
    return float_key(
        __bfloat162float(__ushort_as_bfloat16((unsigned short)b)), op);
  if constexpr (DT == I32) return (int)b;
  if constexpr (DT == I16) return (int)(short)(unsigned short)b;
  if constexpr (DT == I8) return (int)(signed char)(unsigned char)b;
  if constexpr (DT == U8) return (int)(b & 0xFF);
  return (b & 0xFF) != 0;  // BOOL
}

template <int DT>
__device__ __forceinline__ int scalar_key(const void* p, long long i,
                                          int op) {
  constexpr int S = elem_size(DT);
  unsigned b;
  if constexpr (S == 4) b = ((const unsigned*)p)[i];
  if constexpr (S == 2) b = ((const unsigned short*)p)[i];
  if constexpr (S == 1) b = ((const unsigned char*)p)[i];
  return bits_key<DT>(b, op);
}

// the keys of the 16-byte vector that starts at element i (aligned)
template <int DT>
__device__ __forceinline__ void vector_keys(const void* p, long long i,
                                            int op,
                                            int (&k)[16 / elem_size(DT)]) {
  constexpr int S = elem_size(DT);
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(
      static_cast<const char*>(p) + i * S));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 16 / S; ++e)
    k[e] = bits_key<DT>(w[e * S / 4] >> (e * S % 4 * 8), op);
}

// W ids from element i: vector loads where ``vec`` (aligned), else scalar
template <int W>
__device__ __forceinline__ void load_ids(const int* __restrict__ ids,
                                         long long i, bool vec,
                                         int (&s)[W]) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(ids + i) + q);
      s[4 * q] = v.x;
      s[4 * q + 1] = v.y;
      s[4 * q + 2] = v.z;
      s[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) s[e] = ids[i + e];
  }
}

__device__ __forceinline__ int identity_key(int dtype, int op) {
  if (op == SUM) return 0;
  if (op == PROD) return 1;
  const bool lo = op == MAX;  // max starts from the least value
  switch (dtype) {
    case I32: return lo ? INT_MIN : INT_MAX;
    case I8: return lo ? -128 : 127;
    case U8: return lo ? 0 : 255;
    case I16: return lo ? -32768 : 32767;
    case BOOL: return lo ? 0 : 1;
    // the keys of -inf (0xFF800000) and +inf (0x7F800000)
    default: return lo ? (int)0x807FFFFFu : 0x7F800000;
  }
}

__device__ __forceinline__ int combine(int a, int b, int op) {
  switch (op) {
    case SUM: return (int)((unsigned)a + (unsigned)b);
    case PROD: return (int)((unsigned)a * (unsigned)b);
    case MIN: return min(a, b);
    default: return max(a, b);
  }
}

__device__ __forceinline__ void atomic_combine(int* addr, int v, int op) {
  switch (op) {
    case SUM: atomicAdd((unsigned*)addr, (unsigned)v); break;
    case MIN: atomicMin(addr, v); break;
    case MAX: atomicMax(addr, v); break;
    default: {
      int old = *addr, assumed;
      do {
        assumed = old;
        old = atomicCAS(addr, assumed, combine(assumed, v, PROD));
      } while (old != assumed);
    }
  }
}

// Global keys as offsets from the identity (0 for every column): sum k,
// product k - 1, min identity - k, max k - identity (unsigned maxima).
__device__ __forceinline__ void flush_offset(unsigned* addr, int k,
                                             int dtype, int op) {
  switch (op) {
    case SUM: atomicAdd(addr, (unsigned)k); break;
    case MIN:
      atomicMax(addr, (unsigned)identity_key(dtype, MIN) - (unsigned)k);
      break;
    case MAX:
      atomicMax(addr, (unsigned)k - (unsigned)identity_key(dtype, MAX));
      break;
    default: {  // (old + 1) * k - 1
      unsigned old = *addr, assumed;
      do {
        assumed = old;
        old = atomicCAS(addr, assumed, (assumed + 1u) * (unsigned)k - 1u);
      } while (old != assumed);
    }
  }
}

__device__ __forceinline__ int from_offset(unsigned u, int dtype, int op) {
  switch (op) {
    case SUM: return (int)u;
    case PROD: return (int)(u + 1u);
    case MIN: return (int)((unsigned)identity_key(dtype, MIN) - u);
    default: return (int)((unsigned)identity_key(dtype, MAX) + u);
  }
}

// Decode key k of column (dtype, op) into out[s]
__device__ __forceinline__ void store_result(int k, int dtype, int op,
                                             void* out, long long s) {
  switch (dtype) {  // integers narrow modulo their width
    case I32: ((int*)out)[s] = k; return;
    case I8: ((signed char*)out)[s] = (signed char)k; return;
    case U8: ((unsigned char*)out)[s] = (unsigned char)k; return;
    case I16: ((short*)out)[s] = (short)k; return;
    case BOOL: ((unsigned char*)out)[s] = k != 0; return;
    default: break;
  }
  const bool nan = (op == MIN && k == INT_MIN) || (op == MAX && k == INT_MAX);
  // the canonical quiet NaN of each type (PyTorch's conversions give these)
  if (dtype == F32) {
    ((int*)out)[s] = nan ? 0x7FC00000 : k ^ ((k >> 31) & 0x7FFFFFFF);
    return;
  }
  const float f = __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
  unsigned short bits;
  if (dtype == F16) {
    bits = nan ? 0x7E00 : __half_as_ushort(__float2half_rn(f));
  } else {
    bits = nan ? 0x7FC0 : __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  ((unsigned short*)out)[s] = bits;
}

// every thread gets the block's fold of v
__device__ __forceinline__ int block_combine(int v, int op) {
  __shared__ int part[WARPS];
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    v = combine(v, __shfl_xor_sync(0xffffffffu, v, o), op);
  __syncthreads();  // part[] is free again after an earlier call
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v = combine(v, part[w], op);
  return v;
}

// After this block's partials are written: true in the last block of the
// grid to arrive, which then owns every partial.
__device__ __forceinline__ bool last_block(int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
  __syncthreads();
  return last;
}

// ---------------------------------------------------- segid == null

// this thread's fold of a whole column: scalar head and tail, then 16
// keys a step from one to four 16-byte vectors
template <int DT, int OP>
__device__ __forceinline__ int whole_fold(const void* v, long long n,
                                          int head) {
  constexpr int W = 16 / elem_size(DT), U = 16 / W;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * THREADS;
  const long long nvec = (n - head) / W, tail0 = head + nvec * W;
  int acc = identity_key(DT, OP);
  if (tid < head) acc = combine(acc, scalar_key<DT>(v, tid, OP), OP);
  if (tid < n - tail0)
    acc = combine(acc, scalar_key<DT>(v, tail0 + tid, OP), OP);
  long long q = tid;
  for (; q + (U - 1) * nthreads < nvec; q += U * nthreads) {
    int k[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u)
      vector_keys<DT>(v, head + (q + u * nthreads) * W, OP, k[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < W; ++e) acc = combine(acc, k[u][e], OP);
  }
  for (; q < nvec; q += nthreads) {
    int k[W];
    vector_keys<DT>(v, head + q * W, OP, k);
#pragma unroll
    for (int e = 0; e < W; ++e) acc = combine(acc, k[e], OP);
  }
  return acc;
}

template <int DT>
__device__ int whole_fold_dt(const void* v, long long n, int head, int op) {
  switch (op) {
    case SUM: return whole_fold<DT, SUM>(v, n, head);
    case PROD: return whole_fold<DT, PROD>(v, n, head);
    case MIN: return whole_fold<DT, MIN>(v, n, head);
    default: return whole_fold<DT, MAX>(v, n, head);
  }
}

__global__ void __launch_bounds__(THREADS)
fold_whole(long long n, int nseg, const __grid_constant__ Cols cols,
           int ncols, int* __restrict__ partials, int* ticket) {
  const int c = blockIdx.y, dtype = cols.dtype[c], op = cols.op[c];
  const void* v = cols.vals[c];
  const int h = cols.head[c];
  int acc;
  switch (dtype) {
    case F32: acc = whole_fold_dt<F32>(v, n, h, op); break;
    case F16: acc = whole_fold_dt<F16>(v, n, h, op); break;
    case BF16: acc = whole_fold_dt<BF16>(v, n, h, op); break;
    case I8: acc = whole_fold_dt<I8>(v, n, h, op); break;
    case U8: acc = whole_fold_dt<U8>(v, n, h, op); break;
    case I16: acc = whole_fold_dt<I16>(v, n, h, op); break;
    case BOOL: acc = whole_fold_dt<BOOL>(v, n, h, op); break;
    default: acc = whole_fold_dt<I32>(v, n, h, op);
  }
  acc = block_combine(acc, op);
  if (threadIdx.x == 0) partials[c * gridDim.x + blockIdx.x] = acc;
  if (!last_block(ticket)) return;
  for (int c2 = 0; c2 < ncols; ++c2) {
    const int dt2 = cols.dtype[c2], op2 = cols.op[c2];
    const int ident = identity_key(dt2, op2);
    int a = ident;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
      a = combine(a, __ldcg(&partials[c2 * gridDim.x + b]), op2);
    a = block_combine(a, op2);
    if (threadIdx.x == 0) store_result(a, dt2, op2, cols.outs[c2], 0);
    for (int s = 1 + threadIdx.x; s < nseg; s += THREADS)
      store_result(ident, dt2, op2, cols.outs[c2], s);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// ---------------------------------------------------- with segment ids

// One thread's run of elements that share a segment, folded in a register
// and handed to sink(segment, key) at a change; ids outside [0, nseg) are
// skipped.
template <typename Sink>
struct Run {
  Sink sink;
  int nseg, op, cur = -1, acc = 0;
  __device__ Run(Sink sk, int ns, int o) : sink(sk), nseg(ns), op(o) {}
  __device__ __forceinline__ void take(int s, int k) {
    if ((unsigned)s >= (unsigned)nseg) return;
    if (s == cur) {
      acc = combine(acc, k, op);
    } else {
      if (cur >= 0) sink(cur, acc);
      cur = s;
      acc = k;
    }
  }
  __device__ __forceinline__ void flush() {
    if (cur >= 0) sink(cur, acc);
  }
};

// this thread's elements of one column: scalar head and tail, 16-byte
// vectors of values (and of ids where aligned) between
template <int DT, typename Sink>
__device__ __forceinline__ void fold_ids(const int* __restrict__ segid,
                                         long long n, int nseg,
                                         const void* vals, int head,
                                         bool ids_vec, int op, Sink sink) {
  constexpr int W = 16 / elem_size(DT);
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * THREADS;
  const long long nvec = (n - head) / W, tail0 = head + nvec * W;
  Run<Sink> run(sink, nseg, op);
  if (tid < head) run.take(segid[tid], scalar_key<DT>(vals, tid, op));
  for (long long q = tid; q < nvec; q += nthreads) {
    const long long i = head + q * W;
    int k[W], s[W];
    vector_keys<DT>(vals, i, op, k);
    load_ids<W>(segid, i, ids_vec, s);
#pragma unroll
    for (int e = 0; e < W; ++e) run.take(s[e], k[e]);
  }
  if (tid < n - tail0)
    run.take(segid[tail0 + tid], scalar_key<DT>(vals, tail0 + tid, op));
  run.flush();
}

template <typename Sink>
__device__ __forceinline__ void fold_column(const int* __restrict__ segid,
                                            long long n, int nseg,
                                            const Cols& cols, int c,
                                            Sink sink) {
  const void* v = cols.vals[c];
  const int h = cols.head[c], op = cols.op[c];
  const bool iv = cols.ids_vec[c] != 0;
  switch (cols.dtype[c]) {
    case F32: fold_ids<F32>(segid, n, nseg, v, h, iv, op, sink); break;
    case F16: fold_ids<F16>(segid, n, nseg, v, h, iv, op, sink); break;
    case BF16: fold_ids<BF16>(segid, n, nseg, v, h, iv, op, sink); break;
    case I8: fold_ids<I8>(segid, n, nseg, v, h, iv, op, sink); break;
    case U8: fold_ids<U8>(segid, n, nseg, v, h, iv, op, sink); break;
    case I16: fold_ids<I16>(segid, n, nseg, v, h, iv, op, sink); break;
    case BOOL: fold_ids<BOOL>(segid, n, nseg, v, h, iv, op, sink); break;
    default: fold_ids<I32>(segid, n, nseg, v, h, iv, op, sink);
  }
}

// grid (blocks, ncols): one column per blockIdx.y, folded into a shared
// table of nseg keys.  TWO_STAGE: the tables go to the partials and the
// last block folds them into the outputs; else they are flushed into the
// offset keys for the decoding kernel.
template <bool TWO_STAGE>
__global__ void __launch_bounds__(THREADS)
accumulate(const int* __restrict__ segid, long long n, int nseg,
           const __grid_constant__ Cols cols,
           int ncols, int* __restrict__ partials,
           unsigned* __restrict__ keys, int* ticket) {
  extern __shared__ int smem[];
  int* table = smem;  // this block's column: nseg keys
  const int c = blockIdx.y;
  const int dtype = cols.dtype[c], op = cols.op[c];
  const int ident = identity_key(dtype, op);
  for (int s = threadIdx.x; s < nseg; s += THREADS) table[s] = ident;
  __syncthreads();
  fold_column(segid, n, nseg, cols, c, [table, op](int s, int v) {
    atomic_combine(&table[s], v, op);
  });
  __syncthreads();
  if constexpr (!TWO_STAGE) {
    unsigned* col = keys + (long long)c * nseg;
    for (int s = threadIdx.x; s < nseg; s += THREADS)
      if (table[s] != ident) flush_offset(&col[s], table[s], dtype, op);
  } else {
    const int nb = gridDim.x;
    int* mine = partials + ((long long)c * nb + blockIdx.x) * nseg;
    for (int s = threadIdx.x; s < nseg; s += THREADS) mine[s] = table[s];
    if (!last_block(ticket)) return;
    // the last block: each column's nb tables folded into the shared
    // table; entry e of a column's tables is segment e % nseg
    const long long total = (long long)nb * nseg;
    const int step = THREADS % nseg;
    for (int c2 = 0; c2 < ncols; ++c2) {
      const int dt2 = cols.dtype[c2], op2 = cols.op[c2];
      const int id2 = identity_key(dt2, op2);
      __syncthreads();  // the table is free
      for (int s = threadIdx.x; s < nseg; s += THREADS) table[s] = id2;
      __syncthreads();
      const int* part = partials + (long long)c2 * total;
      auto sink = [table, op2](int s, int v) {
        atomic_combine(&table[s], v, op2);
      };
      Run<decltype(sink)> run(sink, nseg, op2);
      int s = threadIdx.x % nseg;
      long long e = threadIdx.x;
      for (; e + 3 * THREADS < total; e += 4 * THREADS) {
        int k[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) k[u] = __ldcg(&part[e + u * THREADS]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          run.take(s, k[u]);
          s += step;
          if (s >= nseg) s -= nseg;
        }
      }
      for (; e < total; e += THREADS) {
        run.take(s, __ldcg(&part[e]));
        s += step;
        if (s >= nseg) s -= nseg;
      }
      run.flush();
      __syncthreads();
      for (int s2 = threadIdx.x; s2 < nseg; s2 += THREADS)
        store_result(table[s2], dt2, op2, cols.outs[c2], s2);
    }
    if (threadIdx.x == 0) *ticket = 0;
  }
}

// few elements for the segments (fewer than the table route would clear
// and scan): each run of a segment goes straight into the offset keys
__global__ void __launch_bounds__(THREADS)
fold_direct(const int* __restrict__ segid, long long n, int nseg,
            const __grid_constant__ Cols cols,
            unsigned* __restrict__ keys) {
  const int c = blockIdx.y, dtype = cols.dtype[c], op = cols.op[c];
  unsigned* col = keys + (long long)c * nseg;
  fold_column(segid, n, nseg, cols, c, [col, dtype, op](int s, int v) {
    flush_offset(&col[s], v, dtype, op);
  });
}

// the offset keys decoded into the outputs, and zeroed for the next call
__global__ void finalize(unsigned* __restrict__ keys, int nseg,
                         const __grid_constant__ Cols cols,
                         int ncols) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nseg * ncols) return;
  const int c = (int)(i / nseg), s = (int)(i % nseg);
  const int dtype = cols.dtype[c], op = cols.op[c];
  store_result(from_offset(keys[i], dtype, op), dtype, op, cols.outs[c], s);
  keys[i] = 0;
}

// per device, found once: SMs, shared memory per SM and per block
// reserved, the table kernels' registers (their shared-memory limit raised
// to MAX_SEGMENTS keys) and the other kernels' blocks per SM
struct DeviceInfo {
  int sms, smem_per_sm, reserved, regs, whole_per_sm, direct_per_sm;
};
DeviceInfo device_info[64];
int device_ready[64];

cudaError_t get_device(const DeviceInfo** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  DeviceInfo& d = device_info[dev];
  if (!__atomic_load_n(&device_ready[dev], __ATOMIC_ACQUIRE)) {
    cudaFuncAttributes a, b;
    const int max_smem = (int)(MAX_SEGMENTS * sizeof(int));
    if ((e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &d.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
             dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &d.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)) !=
            cudaSuccess ||
        (e = cudaFuncGetAttributes(&a, accumulate<true>)) != cudaSuccess ||
        (e = cudaFuncGetAttributes(&b, accumulate<false>)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &d.whole_per_sm, fold_whole, THREADS, 0)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &d.direct_per_sm, fold_direct, THREADS, 0)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(accumulate<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  max_smem)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(accumulate<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  max_smem)) != cudaSuccess)
      return e;
    d.regs = a.numRegs > b.numRegs ? a.numRegs : b.numRegs;
    if (d.regs < 1) d.regs = 32;
    if (d.whole_per_sm < 1) d.whole_per_sm = 1;
    if (d.direct_per_sm < 1) d.direct_per_sm = 1;
    __atomic_store_n(&device_ready[dev], 1, __ATOMIC_RELEASE);
  }
  *out = &d;
  return cudaSuccess;
}

}  // namespace

// vals/outs: host arrays of ncols device pointers; dtypes: 0 f32, 1 f16,
// 2 bf16, 3 int32, 4 int8, 5 uint8, 6 int16, 7 bool; ops: 0 sum, 1 prod,
// 2 min, 3 max (sum/prod on integer columns only).  ws: the workspace,
// dr_segred_workspace_ints() int32, zero when made; it is zero again
// after every call, and one call at a time may use it.  segid may be null
// (every element in segment 0).  One launch, or two with many segments.
extern "C" int dr_segred_workspace_ints() {
  return TICKET_INTS + MAX_COLS * MAX_SEGMENTS + PARTIALS;
}

extern "C" int dr_segred(const int* segid, long long n, int nseg, int ncols,
                         const long long* vals, const int* dtypes,
                         const int* ops, const long long* outs, int* ws,
                         void* stream) {
  if (ncols < 1 || ncols > MAX_COLS || nseg < 1 || nseg > MAX_SEGMENTS ||
      n < 0 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  Cols cols = {};
  for (int c = 0; c < ncols; ++c) {
    if (dtypes[c] < F32 || dtypes[c] > BOOL || ops[c] < SUM || ops[c] > MAX ||
        (ops[c] <= PROD && (dtypes[c] <= BF16 || dtypes[c] == BOOL)))
      return (int)cudaErrorInvalidValue;
    const int size = elem_size(dtypes[c]);
    const unsigned long long addr = (unsigned long long)vals[c];
    if (addr % size != 0) return (int)cudaErrorMisalignedAddress;
    long long h = (long long)((128 - addr % 128) % 128) / size;
    if (h > n) h = n;
    cols.vals[c] = (const void*)vals[c];
    cols.outs[c] = (void*)outs[c];
    cols.dtype[c] = dtypes[c];
    cols.op[c] = ops[c];
    cols.head[c] = (int)h;
    cols.ids_vec[c] =
        segid != nullptr && ((unsigned long long)segid + 4 * h) % 16 == 0;
  }
  const DeviceInfo* d = nullptr;
  cudaError_t e = get_device(&d);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  int* ticket = ws;
  unsigned* keys = (unsigned*)(ws + TICKET_INTS);
  int* partials = ws + TICKET_INTS + MAX_COLS * MAX_SEGMENTS;
  const int threads_per_sm = 2048;
  if (segid == nullptr) {
    // at least 16 elements a thread, at most one full wave of blocks
    long long blocks = (n + THREADS * 16LL - 1) / (THREADS * 16LL);
    long long cap = (long long)d->sms * d->whole_per_sm;
    if (cap > PARTIALS / ncols) cap = PARTIALS / ncols;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    fold_whole<<<dim3((unsigned)blocks, ncols), THREADS, 0, s>>>(
        n, nseg, cols, ncols, partials, ticket);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)nseg * sizeof(int);
  int per_sm = threads_per_sm / THREADS;
  const int by_smem = d->smem_per_sm / (int)(smem + d->reserved);
  const int by_regs = 65536 / (d->regs * THREADS);
  if (by_smem < per_sm) per_sm = by_smem;
  if (by_regs < per_sm) per_sm = by_regs;
  if (per_sm < 1) per_sm = 1;
  long long blocks = (n + THREADS * 16LL - 1) / (THREADS * 16LL);
  if (blocks > (long long)per_sm * d->sms) blocks = (long long)per_sm * d->sms;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, ncols);
  if (blocks * nseg * ncols <= PARTIALS) {
    accumulate<true><<<grid, THREADS, smem, s>>>(segid, n, nseg, cols, ncols,
                                                 partials, keys, ticket);
    return (int)cudaGetLastError();
  }
  if (n < blocks * nseg) {
    long long db = (n + THREADS * 4LL - 1) / (THREADS * 4LL);
    const long long cap = (long long)d->sms * d->direct_per_sm;
    if (db > cap) db = cap;
    if (db < 1) db = 1;
    fold_direct<<<dim3((unsigned)db, ncols), THREADS, 0, s>>>(segid, n, nseg,
                                                             cols, keys);
  } else {
    accumulate<false><<<grid, THREADS, smem, s>>>(segid, n, nseg, cols, ncols,
                                                  partials, keys, ticket);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)nseg * ncols;
  finalize<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(keys, nseg, cols,
                                                           ncols);
  return (int)cudaGetLastError();
}
