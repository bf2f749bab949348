// K6: bitonic sort of a batch of blocks of int32 order keys, keys-only or
// (key, gid) pairs, for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/sort_pallas.py:87 (_build, driven by
// sort_keys :176 and sort_kv :189).  The TPU kernel holds the whole padded
// block (M <= 2^15 keys) in VMEM as an (M/128, 128) tile and runs every
// compare-exchange stage of the network as one vector min/max/select.
//
// Here one launch sorts b blocks (the sample sort's ranks that share a
// device), one CUDA block per row of the (b, n) input; a row is padded to
// M, a power of two in [256, 2^15], with INT32_MAX keys (and INT32_MAX
// gids), which sort to the tail.  Each thread holds E consecutive elements
// of its row in registers (element i = t * E + e, E = 2^L).  The stage
// (k, j) of the network compare-exchanges i and i ^ j, ascending where
// (i & k) == 0.  All stages of one merge level k share each element's
// direction, so a thread flips its elements' bits (~x reverses the signed
// order) where (i & k) != 0 before the level and back after it, and every
// stage in between is a plain min/max, with no direction test.  A level's
// stages run
//   * inside the thread for j < E, with no barrier (levels k <= E with
//     their directions known at compile time);
//   * for k <= 32 E, across the warp for E <= j < k (__shfl_xor_sync with
//     lane mask j / E), with no barrier;
//   * for k > 32 E, the stages E <= j < k in shared memory: the registers
//     are stored, then each pass takes groups of up to 16 elements whose
//     indices differ in up to 4 consecutive bits of j, runs those stages
//     in registers and stores them, one __syncthreads() a pass; the
//     registers are loaded back for the stages j < E.
// At M = 2^14 (E = 16, 1024 threads) the network's 105 stages take 15
// shuffle stages, 12 shared-memory passes and 5 round trips.  Shared
// memory is padded (see slot()) so that none of these accesses has a
// bank conflict.
//
// Order: a pair travels as one int64, key << 32 | (gid ^ INT_MIN), whose
// signed order is the (key, gid) order, a total order; so the output is
// the unique sorted sequence and equals torch.sort of the packed pairs
// bit for bit.  Keys-only sorts the int32 keys.
//
// KV at M = 2^15 (256 KB of pairs) does not fit one block's 227 KB of
// shared memory, nor its 256 KB of registers beside the indices.  Design
// chosen: a cluster of two blocks, each holding 2^14 pairs.  Every stage
// but one stays inside a block: the merge levels up to 2^14 are each
// block's own (the direction bit is that of the row index, so the second
// block sorts its half descending), and the last level's first stage,
// j = 2^14, pairs element i of the first half with element i of the
// second.  That stage reads the partner block's shared memory (distributed
// shared memory) between two cluster barriers; the rest of the level is
// local again, so the pairs cross between the SMs once and never go
// through device memory.
//
// Bound on the H100: a launch reads and writes each key (and gid) once,
// a few hundred KB a row, so its floor is the compare-exchanges:
// M/2 * log2(M) * (log2(M) + 1) / 2 a row, 2 operations each, over the
// card; one row uses one SM (two for KV at 2^15), so one row alone is
// bounded by one SM's share, 132 times the card's floor.  Shuffles (one
// warp-wide per clock an SM) and shared-memory words (32 per clock) are
// what the design spends beside the compares.
//
// The dynamic shared-memory limit is raised once per process, device and
// kernel variant, not on every call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_M = 1 << 15;
constexpr int MAX_THREADS = 1024;

// the (key, gid) pair as one int64 in pair order
__device__ __forceinline__ long long pack(int k, int g) {
  return (long long)(((unsigned long long)(unsigned)k << 32) |
                     (unsigned)(g ^ INT_MIN));
}

template <typename T>
struct Elem;
template <>
struct Elem<int> {  // keys only
  __device__ static int pad() { return INT_MAX; }
  __device__ static int load(const int* k, const int*, long long i) {
    return k[i];
  }
  __device__ static void store(int v, int* k, int*, long long i) {
    k[i] = v;
  }
};
template <>
struct Elem<long long> {  // (key, gid) pairs
  __device__ static long long pad() { return pack(INT_MAX, INT_MAX); }
  __device__ static long long load(const int* k, const int* g, long long i) {
    return pack(k[i], g[i]);
  }
  __device__ static void store(long long v, int* k, int* g, long long i) {
    k[i] = (int)(v >> 32);
    g[i] = (int)((unsigned)v ^ 0x80000000u);
  }
};

// The shared-memory slot of element i: one padding word after every 32
// words (one pair after every 16 pairs), so that a thread's E consecutive
// elements (i = t * E + e over a warp's t), the passes and the staging
// loops touch 32 distinct banks (pairs: 16 distinct bank pairs a
// half-warp).  The map is additive over disjoint bits, so slot(a | b) =
// slot(a) + slot(b): every address a pass or a round trip needs is one
// base plus a constant.
template <typename T>
__device__ __forceinline__ int slot(int i) {
  return i + (i >> (sizeof(T) == 8 ? 4 : 5));
}

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a < b ? b : a; }

template <typename T>
__device__ __forceinline__ void ascend(T& a, T& b) {
  const T lo = tmin(a, b);
  b = tmax(a, b);
  a = lo;
}

template <typename T, int E>
__device__ __forceinline__ void flip(T (&x)[E], T m) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] ^= m;
}

// stages J, J/2, ..., 1 over the groups of G consecutive registers from
// x[o], ascending (for a level whose elements were flipped as needed)
template <int J, int G, int O, int E, typename T>
__device__ __forceinline__ void merge(T (&x)[E]) {
  if constexpr (J >= 1) {
#pragma unroll
    for (int e = 0; e < G; ++e)
      if ((e & J) == 0) ascend(x[O + e], x[O + (e | J)]);
    merge<J / 2, G, O, E>(x);
  }
}

// merge() over each of the R groups of GS registers
template <int R, int GS, int E, typename T>
__device__ __forceinline__ void merge_groups(T (&x)[E]) {
  if constexpr (R > 0) {
    merge<GS / 2, GS, (R - 1) * GS, E>(x);
    merge_groups<R - 1, GS, E>(x);
  }
}

// level K < E inside the thread: stages J..1, element e ascending where
// (e & K) == 0, known at compile time
template <int K, int J, int E, typename T>
__device__ __forceinline__ void small_level(T (&x)[E]) {
  if constexpr (J >= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if ((e & J) == 0) {
        if (e & K)
          ascend(x[e | J], x[e]);
        else
          ascend(x[e], x[e | J]);
      }
    small_level<K, J / 2, E>(x);
  }
}

// levels 2..E, all inside the thread; ib is the row index of x[0]
template <int K, int E, typename T>
__device__ __forceinline__ void thread_sort(T (&x)[E], int ib) {
  if constexpr (K < E) {
    small_level<K, K / 2, E>(x);
    thread_sort<2 * K, E>(x, ib);
  } else {
    const T m = (ib & E) ? (T)-1 : (T)0;
    flip(x, m);
    merge<E / 2, E, 0, E>(x);
    flip(x, m);
  }
}

// element t*E + e sits at slot(t*E) + e (e < E < 32 adds no padding)
template <typename T, int E>
__device__ __forceinline__ void to_shared(T* s, const T (&x)[E], int sb) {
#pragma unroll
  for (int e = 0; e < E; ++e) s[sb + e] = x[e];
}

template <typename T, int E>
__device__ __forceinline__ void from_shared(const T* s, T (&x)[E], int sb) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = s[sb + e];
}

// One shared-memory pass: the G stages j = 2^(P + G - 1) .. 2^P.  The
// thread takes E / 2^G groups of 2^G elements, one after another, whose
// indices differ in bits P .. P + G - 1 (group q: those bits inserted
// into q at P).  For 4-byte keys with E = 16, the pass at P = 4 puts q's
// bit 4 (lane bit 4) at index bit 9 and q's bit 5 at bit 8: slot() maps
// bit 9, not bit 8, to the other half of the banks.
template <int G, int P, typename T, int E>
__device__ __forceinline__ void pass(T* s, int t, int nt) {
  constexpr int GS = 1 << G, LOW = (1 << P) - 1;
#pragma unroll
  for (int r = 0; r < E / GS; ++r) {
    const int q = t + r * nt;
    int base = ((q & ~LOW) << G) | (q & LOW);
    if constexpr (sizeof(T) == 4 && E == 16 && P == 4)
      base ^= (((base >> 8) ^ (base >> 9)) & 1) * 0x300;
    const int sb = slot<T>(base);
    T y[GS];
#pragma unroll
    for (int e = 0; e < GS; ++e) y[e] = s[sb + slot<T>(e << P)];
    merge<GS / 2, GS, 0, GS>(y);
#pragma unroll
    for (int e = 0; e < GS; ++e) s[sb + slot<T>(e << P)] = y[e];
  }
}

// pass<G, p> for a runtime p in [P, 15 - G]
template <int G, int P, typename T, int E>
__device__ __forceinline__ void pass_at(T* s, int t, int nt, int p) {
  if constexpr (P + G <= 15) {
    if (p == P)
      pass<G, P, T, E>(s, t, nt);
    else
      pass_at<G, P + 1, T, E>(s, t, nt, p);
  }
}

// the passes of one level over bits hi .. L of j (at least PG of them): a
// top pass of (hi - L + 1) % PG bits if any, then passes of PG bits
template <typename T, int E, int L>
__device__ __forceinline__ void shared_stages(T* s, int t, int nt, int hi) {
  constexpr int PG = 4;  // stage bits a pass: 16 elements a group
  const int top = (hi - L + 1) % PG;
  switch (top) {
    case 1: pass_at<1, L, T, E>(s, t, nt, hi); break;
    case 2: pass_at<2, L, T, E>(s, t, nt, hi - 1); break;
    case 3: pass_at<3, L, T, E>(s, t, nt, hi - 2); break;
    default: break;
  }
  if (top) __syncthreads();
  for (int p = hi - top - PG + 1; p >= L; p -= PG) {
    pass_at<PG, L, T, E>(s, t, nt, p);
    __syncthreads();
  }
}

// One row, or (CLUSTER) one half of a row per block of a two-block
// cluster.  kin/gin: (b, n) row-major; kout/gout: (b, M) row-major.
template <typename T, int E, bool CLUSTER>
__device__ __forceinline__ void sort_rows(const int* __restrict__ kin,
                                          const int* __restrict__ gin,
                                          int n, int M,
                                          int* __restrict__ kout,
                                          int* __restrict__ gout) {
  constexpr int L = E == 8 ? 3 : E == 16 ? 4 : 5;
  static_assert(1 << L == E, "E is 8, 16 or 32");
  extern __shared__ __align__(16) unsigned char raw[];
  T* s = reinterpret_cast<T*>(raw);
  const int t = threadIdx.x, nt = blockDim.x;
  int rank = 0;
  if constexpr (CLUSTER) rank = (int)cg::this_cluster().block_rank();
  const long long row = CLUSTER ? blockIdx.x >> 1 : blockIdx.x;
  const int ml = CLUSTER ? M >> 1 : M;  // elements this block holds
  const int base = rank * ml;           // the row index of its first one
  const long long in0 = row * n, out0 = row * M + base;

  // coalesced load through shared memory, pads past n
  for (int i = t; i < ml; i += nt)
    s[slot<T>(i)] = base + i < n
                           ? Elem<T>::load(kin, gin, in0 + base + i)
                           : Elem<T>::pad();
  __syncthreads();
  T x[E];
  const int sb = slot<T>(t * E);
  from_shared<T, E>(s, x, sb);
  const int ib = base + t * E;
  thread_sort<2, E>(x, ib);

  for (int k = 2 * E; k <= M; k <<= 1) {
    const T m = (ib & k) ? (T)-1 : (T)0;
    flip(x, m);
    int j = k >> 1;
    if constexpr (CLUSTER) {
      if (j == ml) {  // i of the first half against i of the second
        cg::cluster_group cluster = cg::this_cluster();
        to_shared<T, E>(s, x, sb);
        cluster.sync();
        const T* other = cluster.map_shared_rank(s, rank ^ 1);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const T o = other[sb + e];
          x[e] = rank == 0 ? tmin(x[e], o) : tmax(x[e], o);
        }
        cluster.sync();  // the partner is done reading before we write
        j >>= 1;
      }
    }
    if (k > 32 * E) {
      to_shared<T, E>(s, x, sb);
      __syncthreads();
      if constexpr (E >= 16) shared_stages<T, E, L>(s, t, nt, 31 - __clz(j));
      from_shared<T, E>(s, x, sb);
    } else {
      for (; j >= E; j >>= 1) {
        const int lm = j >> L;  // the partner lane's xor, below 32
        const bool lower = (t & lm) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const T o = __shfl_xor_sync(0xffffffffu, x[e], lm);
          x[e] = lower ? tmin(x[e], o) : tmax(x[e], o);
        }
      }
    }
    merge<E / 2, E, 0, E>(x);
    flip(x, m);
  }

  // coalesced store through shared memory (each thread rewrites only the
  // slots it read last, so no barrier is needed before this)
  to_shared<T, E>(s, x, sb);
  __syncthreads();
  for (int i = t; i < ml; i += nt)
    Elem<T>::store(s[slot<T>(i)], kout, gout, out0 + i);
}

template <typename T, int E>
__global__ void __launch_bounds__(MAX_THREADS)
bitonic(const int* __restrict__ kin, const int* __restrict__ gin, int n,
        int M, int* __restrict__ kout, int* __restrict__ gout) {
  sort_rows<T, E, false>(kin, gin, n, M, kout, gout);
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(MAX_THREADS)
bitonic_pairs_cluster(const int* __restrict__ kin,
                      const int* __restrict__ gin, int n, int M,
                      int* __restrict__ kout, int* __restrict__ gout) {
  sort_rows<long long, 16, true>(kin, gin, n, M, kout, gout);
}

// shared-memory bytes of a block of ml elements with their padding
template <typename T>
size_t smem_bytes(int ml) {
  return (size_t)(ml + ml / (sizeof(T) == 8 ? 16 : 32)) * sizeof(T);
}

// Raise a variant's dynamic shared-memory limit to its largest block once
// per device (a bit per device; devices past 63 set it on every call).
cudaError_t allow_smem(const void* fn, int variant, size_t bytes) {
  static unsigned long long done[6] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (__atomic_load_n(&done[variant], __ATOMIC_ACQUIRE) & bit))
    return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && bit)
    __atomic_fetch_or(&done[variant], bit, __ATOMIC_RELEASE);
  return e;
}

template <typename T, int E>
cudaError_t launch(int variant, int max_m, const int* kin, const int* gin,
                   int n, int M, long long b, int* kout, int* gout,
                   cudaStream_t s) {
  cudaError_t e = allow_smem((const void*)bitonic<T, E>, variant,
                             smem_bytes<T>(max_m));
  if (e != cudaSuccess) return e;
  bitonic<T, E><<<(unsigned)b, M / E, smem_bytes<T>(M), s>>>(kin, gin, n, M,
                                                             kout, gout);
  return cudaGetLastError();
}

}  // namespace

// Sorts each row of keys_in (b, n) (and gid_in, or null for keys-only),
// padded to M = a power of two in [256, 2^15] with n <= M; keys_out and
// gid_out are (b, M), each row the sorted reals first, then the pads.
// One launch: b blocks, or b two-block clusters for pairs at M = 2^15.
extern "C" int dr_bitonic_sort(const int* keys_in, const int* gid_in,
                               long long n, int M, long long b,
                               int* keys_out, int* gid_out, void* stream) {
  if (n < 1 || M < 256 || M > MAX_M || (M & (M - 1)) != 0 || n > M ||
      b < 1 || b >= (1LL << 30) || (gid_in != nullptr) != (gid_out != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nn = (int)n;
  if (gid_in == nullptr) {
    if (M == 256)
      return (int)launch<int, 8>(0, 256, keys_in, nullptr, nn, M, b,
                                 keys_out, nullptr, s);
    if (M < MAX_M)
      return (int)launch<int, 16>(1, MAX_M / 2, keys_in, nullptr, nn, M, b,
                                  keys_out, nullptr, s);
    return (int)launch<int, 32>(2, MAX_M, keys_in, nullptr, nn, M, b,
                                keys_out, nullptr, s);
  }
  if (M == 256)
    return (int)launch<long long, 8>(3, 256, keys_in, gid_in, nn, M, b,
                                     keys_out, gid_out, s);
  if (M < MAX_M)
    return (int)launch<long long, 16>(4, MAX_M / 2, keys_in, gid_in, nn, M,
                                      b, keys_out, gid_out, s);
  const size_t half = smem_bytes<long long>(MAX_M / 2);
  cudaError_t e = allow_smem((const void*)bitonic_pairs_cluster, 5, half);
  if (e != cudaSuccess) return (int)e;
  bitonic_pairs_cluster<<<(unsigned)(2 * b), MAX_M / 2 / 16, half, s>>>(
      keys_in, gid_in, nn, M, keys_out, gid_out);
  return (int)cudaGetLastError();
}
