// K6: bitonic sort of one rank's block of int32 order keys, keys-only or
// (key, gid) pairs, for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/sort_pallas.py:87 (_build, driven by
// sort_keys :176 and sort_kv :189).  The TPU kernel holds the whole padded
// block (M <= 2^15 keys) in VMEM as an (M/128, 128) tile and runs every
// compare-exchange stage of the network as one vector min/max/select.  Here
// one block of 1024 threads runs the same network over the block in dynamic
// shared memory: each stage (k, j) compare-exchanges all M/2 pairs
// (i, i + j), each thread a strided share of them, and __syncthreads()
// separates the stages.  Pads (i >= n) load as INT32_MAX (and gid INT32_MAX),
// sort to the tail, and the wrapper slices them off.
//
// Order: keys-only compares the keys; KV compares (key, gid)
// lexicographically, a total order, so the output is the unique sorted
// sequence and equals torch.sort of the same encoding bit for bit.
//
// Shared memory: keys-only at M = 2^15 is 128 KB and fits one block (227 KB).
// KV at M = 2^15 is 256 KB and does not.  Design chosen: a shared tile of
// T = 2^14 pairs (128 KB).  Stages with j < T pair elements inside one
// aligned T-chunk and run in shared memory, chunk after chunk; the few
// stages with j >= T (one at M = 2^15) run as a compare-exchange pass over
// device memory (the output buffer, M long), which the block reads back after
// a __syncthreads().  The other option, a two-block cluster reading the
// partner's shared memory, would split each stage across two SMs and need a
// cluster barrier per stage; the tiled form keeps one block and one kind of
// barrier, and only one of the network's 120 stages touches device memory.
//
// Bound on the H100: it reads and writes each key (and gid) once, a few
// hundred KB, so its card-wide floor is the compare-exchanges:
// M/2 * log2(M) * (log2(M) + 1) / 2 of them, 2 operations each.  One block
// per shard uses one of the 132 SMs, so that design's floor is 132 times the
// card's; each stage also moves 16 B (KV 32 B) of shared memory per pair.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int KEYS_TILE = 1 << 15;  // keys-only: 128 KB of shared memory
constexpr int KV_TILE = 1 << 14;    // (key, gid) pairs: 128 KB

// ascending: after the exchange k[a] <= k[b] (pair order for KV).  Every
// index fits an int (M <= 2^15), so the index arithmetic stays 32-bit.
template <bool KV>
__device__ __forceinline__ void cmpx(int* k, int* g, int a, int b,
                                     bool ascending) {
  const int ka = k[a], kb = k[b];
  bool a_after;
  if (KV) {
    const int ga = g[a], gb = g[b];
    a_after = ka > kb || (ka == kb && ga > gb);
  } else {
    a_after = ka > kb;
  }
  if (a_after == ascending) {
    k[a] = kb;
    k[b] = ka;
    if (KV) {
      const int t = g[a];
      g[a] = g[b];
      g[b] = t;
    }
  }
}

// the pair index p's lower element: insert a 0 bit at j's position
__device__ __forceinline__ int lower(int p, int j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// stages j = j_hi .. 1 of merge level k over one T-chunk in shared memory;
// ``base`` is the chunk's first global index (the direction bit is global)
template <bool KV>
__device__ void chunk_stages(int* sk, int* sg, int T, int base, int k,
                             int j_hi) {
  for (int j = j_hi; j >= 1; j >>= 1) {
    for (int p = threadIdx.x; p < T / 2; p += THREADS) {
      const int lo = lower(p, j);
      cmpx<KV>(sk, sg, lo, lo + j, ((base + lo) & k) == 0);
    }
    __syncthreads();
  }
}

template <bool KV>
__device__ void load_chunk(int* sk, int* sg, const int* kin, const int* gin,
                           int base, int T, int n) {
  for (int t = threadIdx.x; t < T; t += THREADS) {
    const int i = base + t;
    sk[t] = i < n ? kin[i] : INT_MAX;
    if (KV) sg[t] = i < n ? gin[i] : INT_MAX;
  }
  __syncthreads();
}

template <bool KV>
__device__ void store_chunk(const int* sk, const int* sg, int* kout,
                            int* gout, int base, int T) {
  for (int t = threadIdx.x; t < T; t += THREADS) {
    kout[base + t] = sk[t];
    if (KV) gout[base + t] = sg[t];
  }
  __syncthreads();
}

template <bool KV>
__global__ void __launch_bounds__(THREADS)
bitonic(const int* __restrict__ kin, const int* __restrict__ gin, int n,
        int M, int T, int* kout, int* gout) {
  extern __shared__ int smem[];
  int* sk = smem;
  int* sg = KV ? smem + T : nullptr;
  const int nchunks = M / T;
  // merge levels k <= T: every stage stays inside one T-chunk
  for (int c = 0; c < nchunks; ++c) {
    const int base = c * T;
    load_chunk<KV>(sk, sg, kin, gin, base, T, n);
    for (int k = 2; k <= T; k <<= 1)
      chunk_stages<KV>(sk, sg, T, base, k, k >> 1);
    store_chunk<KV>(sk, sg, kout, gout, base, T);
  }
  // merge levels k > T (KV at M = 2^15 only): stages j >= T over device
  // memory, then the chunk-local stages j < T in shared memory
  for (int k = 2 * T; k <= M; k <<= 1) {
    for (int j = k >> 1; j >= T; j >>= 1) {
      for (int p = threadIdx.x; p < M / 2; p += THREADS) {
        const int lo = lower(p, j);
        cmpx<KV>(kout, gout, lo, lo + j, (lo & k) == 0);
      }
      __syncthreads();
    }
    for (int c = 0; c < nchunks; ++c) {
      const int base = c * T;
      load_chunk<KV>(sk, sg, kout, gout, base, T, M);
      chunk_stages<KV>(sk, sg, T, base, k, T >> 1);
      store_chunk<KV>(sk, sg, kout, gout, base, T);
    }
  }
}

}  // namespace

// One block sorts keys_in[0, n) (and gid_in, or null for keys-only) padded
// to M = a power of two in [256, 2^15]; keys_out/gid_out hold M elements,
// the sorted reals first.
extern "C" int dr_bitonic_sort(const int* keys_in, const int* gid_in,
                               long long n, int M, int* keys_out,
                               int* gid_out, void* stream) {
  if (n < 1 || M < 256 || M > KEYS_TILE || (M & (M - 1)) != 0 || n > M ||
      (gid_in != nullptr) != (gid_out != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool kv = gid_in != nullptr;
  const int tile = kv ? KV_TILE : KEYS_TILE;
  const int T = M < tile ? M : tile;
  const size_t smem = (size_t)T * sizeof(int) * (kv ? 2 : 1);
  cudaError_t e;
  if (kv) {
    e = cudaFuncSetAttribute(bitonic<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    bitonic<true><<<1, THREADS, smem, s>>>(keys_in, gid_in, (int)n, M, T,
                                           keys_out, gid_out);
  } else {
    e = cudaFuncSetAttribute(bitonic<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    bitonic<false><<<1, THREADS, smem, s>>>(keys_in, nullptr, (int)n, M, T,
                                            keys_out, nullptr);
  }
  return (int)cudaGetLastError();
}
