// K7: segmented reduce of sum/prod/min/max columns over int32 segment ids,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/segred_pallas.py:89 (_build, driven by
// segmented :134).  The TPU kernel keeps the values and ids in VMEM and, per
// 128-segment output tile, builds the (128, n) membership mask and reduces
// along it: O(n * nseg / 128) work, which is why it capped n at 2^15.  On
// Hopper a block keeps one column's nseg keys in shared memory (nseg <= 2^15:
// at most 128 KB) and folds its elements into them with shared-memory
// atomics: O(n) work for any n.  Every eligible monoid is order-free at the
// bit level, so the atomics' order does not change the result:
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
//     NaN flag and the result propagates NaN, as XLA's min/max do;
//   * min/max are atomicMin/atomicMax on the keys, sum atomicAdd, product a
//     compare-and-swap loop.
//
// Launches: one sets every global key to the identity, one accumulates
// (grid (blocks, ncols), one column per blockIdx.y, its loop compiled for
// the column's dtype, so the inner loop has no per-element dtype switch;
// each thread folds a run of its elements that share a segment in a register
// and flushes at a change, so a single segment costs one shared atomic per
// thread; a block then folds its
// non-identity entries into the global keys with global atomics), one decodes
// the keys into the outputs.  Ids outside [0, nseg) are skipped; a null segid
// puts every element in segment 0 and reads no ids.
//
// Bound on the H100: it reads each value (and id) once and writes nseg
// results, a few integer operations per element, so it is bytes-bound at
// 3.35 TB/s for large n.  Contended atomics (few segments, many elements) are
// what the register run-length fold keeps off the shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_COLS = 4;
constexpr int MAX_SEGMENTS = 1 << 15;
enum { F32 = 0, F16 = 1, BF16 = 2, I32 = 3, I8 = 4, U8 = 5, I16 = 6, BOOL = 7 };
enum { SUM = 0, PROD = 1, MIN = 2, MAX = 3 };

struct Cols {
  const void* vals[MAX_COLS];
  void* outs[MAX_COLS];
  int dtype[MAX_COLS];
  int op[MAX_COLS];
};

__device__ __forceinline__ int float_key(float f, int op) {
  if (f != f) return op == MIN ? INT_MIN : INT_MAX;
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7FFFFFFF);
}

// DT is a compile-time column dtype: each column's loop reads one type
template <int DT>
__device__ __forceinline__ int load_key(const void* p, long long i, int op) {
  switch (DT) {
    case F32: return float_key(((const float*)p)[i], op);
    case F16: return float_key(__half2float(((const __half*)p)[i]), op);
    case BF16:
      return float_key(__bfloat162float(((const __nv_bfloat16*)p)[i]), op);
    case I8: return ((const signed char*)p)[i];
    case U8: return ((const unsigned char*)p)[i];
    case I16: return ((const short*)p)[i];
    case BOOL: return ((const unsigned char*)p)[i] != 0;
    default: return ((const int*)p)[i];
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

__global__ void init_keys(int* __restrict__ keys, int nseg, Cols cols,
                          int ncols) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nseg * ncols) return;
  const int c = (int)(i / nseg);
  keys[i] = identity_key(cols.dtype[c], cols.op[c]);
}

// One thread's elements folded into the block's table: a run of elements
// that share a segment stays in a register and is flushed at a change.
template <int DT>
__device__ __forceinline__ void fold(const int* __restrict__ segid,
                                     long long n, int nseg, const void* vals,
                                     int op, int ident, int* table) {
  const long long stride = (long long)gridDim.x * THREADS;
  int cur = -1, acc = ident;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const int s = segid ? segid[i] : 0;
    if ((unsigned)s >= (unsigned)nseg) continue;
    const int k = load_key<DT>(vals, i, op);
    if (s == cur) {
      acc = combine(acc, k, op);
    } else {
      if (cur >= 0) atomic_combine(&table[cur], acc, op);
      cur = s;
      acc = k;
    }
  }
  if (cur >= 0) atomic_combine(&table[cur], acc, op);
}

__global__ void __launch_bounds__(THREADS)
accumulate(const int* __restrict__ segid, long long n, int nseg, Cols cols,
           int* __restrict__ keys) {
  extern __shared__ int table[];  // this block's column: nseg keys
  const int c = blockIdx.y;
  const int dtype = cols.dtype[c], op = cols.op[c];
  const int ident = identity_key(dtype, op);
  for (int s = threadIdx.x; s < nseg; s += THREADS) table[s] = ident;
  __syncthreads();
  const void* v = cols.vals[c];
  switch (dtype) {
    case F32: fold<F32>(segid, n, nseg, v, op, ident, table); break;
    case F16: fold<F16>(segid, n, nseg, v, op, ident, table); break;
    case BF16: fold<BF16>(segid, n, nseg, v, op, ident, table); break;
    case I8: fold<I8>(segid, n, nseg, v, op, ident, table); break;
    case U8: fold<U8>(segid, n, nseg, v, op, ident, table); break;
    case I16: fold<I16>(segid, n, nseg, v, op, ident, table); break;
    case BOOL: fold<BOOL>(segid, n, nseg, v, op, ident, table); break;
    default: fold<I32>(segid, n, nseg, v, op, ident, table);
  }
  __syncthreads();
  int* col_keys = keys + (long long)c * nseg;
  for (int s = threadIdx.x; s < nseg; s += THREADS)
    if (table[s] != ident) atomic_combine(&col_keys[s], table[s], op);
}

__global__ void finalize(const int* __restrict__ keys, int nseg, Cols cols,
                         int ncols) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nseg * ncols) return;
  const int c = (int)(i / nseg), s = (int)(i % nseg);
  const int k = keys[i], dtype = cols.dtype[c], op = cols.op[c];
  void* out = cols.outs[c];
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

}  // namespace

// vals/outs: host arrays of ncols device pointers; dtypes: 0 f32, 1 f16,
// 2 bf16, 3 int32, 4 int8, 5 uint8, 6 int16, 7 bool; ops: 0 sum, 1 prod,
// 2 min, 3 max (sum/prod on integer columns only).  keys: ncols * nseg
// int32 scratch.  segid may be null.
extern "C" int dr_segred(const int* segid, long long n, int nseg, int ncols,
                         const long long* vals, const int* dtypes,
                         const int* ops, const long long* outs, int* keys,
                         void* stream) {
  if (ncols < 1 || ncols > MAX_COLS || nseg < 1 || nseg > MAX_SEGMENTS ||
      n < 0)
    return (int)cudaErrorInvalidValue;
  Cols cols = {};
  for (int c = 0; c < ncols; ++c) {
    if (dtypes[c] < F32 || dtypes[c] > BOOL || ops[c] < SUM || ops[c] > MAX ||
        (ops[c] <= PROD && (dtypes[c] <= BF16 || dtypes[c] == BOOL)))
      return (int)cudaErrorInvalidValue;
    cols.vals[c] = (const void*)vals[c];
    cols.outs[c] = (void*)outs[c];
    cols.dtype[c] = dtypes[c];
    cols.op[c] = ops[c];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)nseg * ncols;
  const int tb = 256;
  const int tblocks = (int)((total + tb - 1) / tb);
  init_keys<<<tblocks, tb, 0, s>>>(keys, nseg, cols, ncols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    const size_t smem = (size_t)nseg * sizeof(int);
    e = cudaFuncSetAttribute(accumulate,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(MAX_SEGMENTS * sizeof(int)));
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, accumulate,
                                                  THREADS, smem);
    if (per_sm < 1) per_sm = 1;
    // 16 elements per thread at least, at most one full wave of blocks
    long long blocks = (n + THREADS * 16LL - 1) / (THREADS * 16LL);
    if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
    accumulate<<<dim3((unsigned)blocks, ncols), THREADS, smem, s>>>(
        segid, n, nseg, cols, keys);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  finalize<<<tblocks, tb, 0, s>>>(keys, nseg, cols, ncols);
  return (int)cudaGetLastError();
}
