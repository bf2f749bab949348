// K4: seeded inclusive add-scan for Hopper (sm_90a), one launch a call.
//
// Replaces the TPU kernel dr_tpu/ops/scan_pallas.py:244 (_build) and its
// auto-pipelined twin :198 (_build_grid), driven by chunked_cumsum.  The
// TPU kernel makes one pass over HBM, carrying a running sum in SMEM
// across its sequential grid.  Hopper runs blocks in no order, so the
// carry becomes a look-back between tiles:
//
//   * Each block takes one tile of 32 KB (8192 f32, 16384 bf16/f16).
//     Which tile comes from an atomicAdd ticket, not from blockIdx, so a
//     block only ever waits on tiles whose blocks started before it (and
//     so are resident).
//   * The tile is read once, by 16-byte cp.async copies straight into
//     shared memory (a warp's copies cover 512 contiguous bytes).  A tile
//     waits there, not in registers, while its prefix is found: a tile
//     cannot be written before every earlier tile has been read, so each
//     one waits for the slowest load among its predecessors, and the
//     bytes in flight are what the waiting tiles leave free.  Shared
//     memory holds six 32 KB tiles an SM where registers held four 16 KB
//     ones (on an H100 at 2^30 f32: 4.6-4.7 ms that way, 3.2 this way;
//     PERF.md §6).
//   * Each vector is summed, each row of 32 vectors scanned across its
//     warp with shuffles, the rows in order through shared memory.  The
//     block publishes its aggregate A(b), finds its exclusive prefix
//     E(b), publishes the inclusive I(b) = E(b) + A(b), then reads its
//     tile from shared memory again, adds the prefixes, rounds once to
//     the output type and writes it once, with 16-byte streaming stores.
//
// Determinism: the textbook look-back adds aggregates back to the first
// tile it finds with an inclusive prefix, and where that is depends on
// timing.  Here tile b always takes the inclusive prefix of tile b - LB
// (LB = 128) and adds the aggregates of tiles b - LB + 1 .. b - 1, one
// warp reading 32 at a time, each lane in a fixed order, then a fixed
// butterfly across lanes; tiles b < LB start from the carry.  So the
// sums are the same every run.  The chain advances LB tiles per
// look-back latency (~1 us), far more than the ~45 tiles/us that 132 SMs
// stream at the HBM rate.  These LB interleaved chains each add
// ~n / (8192 LB) terms, so they are summed in f64: tiles next to each
// other, on different chains, then agree to far below an f32 ulp of the
// prefix, and an output's error is that of rounding E(b) to f32 once
// plus the tile's own f32 sums (the same depth as the earlier design's).
//
// Status words: one 64-bit word a tile for A(b) and one for I(b), each
// the f64 value with its lowest bit forced to 1; zero means "not yet".
// (An f32 aggregate widened to f64 has that bit clear, so A(b) is exact;
// I(b) loses its lowest f64 bit, the same on every run.)  The value is
// the flag, so relaxed gpu-scope loads and stores suffice: nothing else
// is published through them.  The wrapper zeroes the ticket and status
// words for every call (torch.zeros on the call's stream, 16 bytes a
// tile); no scratch outlives a call or is shared between streams.
//
// Misaligned starts: the wrapper gives `out` the same offset within 16
// bytes as `x` (the distributed scan passes rank views a halo off a
// boundary).  Tiles are cut in aligned coordinates: element i sits at
// i + s, where s is x's offset in elements, so every vector is aligned
// in both arrays, and only the first and the last vector of the call
// are partly outside [0, n) (those load and store element by element).
//
// The carry (an f32 device scalar, or 0 when the pointer is null) seeds
// tiles b < LB, as it seeded the running sum of the earlier design, so
// carry + prefix keeps its meaning.  All sums are f32 within a tile and
// f64 between tiles, whatever the input type (f32, bf16, f16); the
// output has the input's type, as in the JAX kernel.
//
// Bound on the H100: one read and one write, 8 bytes an f32 element
// (3.35 TB/s); the status words add 16 bytes a 32 KB tile.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_BYTES = 32768;     // a tile: 8192 f32, 16384 bf16/f16
constexpr int NV = TILE_BYTES / 16;   // 16-byte vectors a tile
constexpr int K = NV / THREADS;       // vectors a thread
constexpr int LB = 128;               // look-back distance in tiles
constexpr int WS_HEAD = 16;           // ticket, padded to 128 bytes

typedef unsigned long long u64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a 16-byte vector of T as V floats, and back
template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&f)[Vec<T>::N]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < Vec<T>::N; ++k) f[k] = to_f(e[k]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[Vec<T>::N]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int k = 0; k < Vec<T>::N; ++k) e[k] = from_f<T>(f[k]);
  return u;
}

// 16 bytes from device memory to shared memory, not through registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 encode(double v) {
  return (static_cast<u64>(__double_as_longlong(v)) & ~1ull) | 1ull;
}
__device__ __forceinline__ double decode(u64 w) {
  return __longlong_as_double(static_cast<long long>(w & ~1ull));
}

// The exclusive prefix of tile b, from the status words (one warp).
// Every lane loads its aggregates and the inclusive prefix of tile b - LB
// at once, then re-reads, again all at once, the words not yet published,
// so a wait costs one round trip to L2 however many words it waits on.
// A wait past 2^36 cycles (about 40 s: a tile that never publishes) traps,
// so the launch fails rather than hanging the card.
__device__ __forceinline__ double look_back(const u64* agg, const u64* incl,
                                            long long b, double carry,
                                            int lane) {
  constexpr int K = LB / 32;
  const long long lo = b >= LB ? b - LB + 1 : 0;
  u64 w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long j = lo + lane + 32LL * k;
    w[k] = j < b ? ld_relaxed(agg + j) : 1ull;  // 1 decodes to +0.0
  }
  u64 base = b >= LB ? ld_relaxed(incl + (b - LB)) : 1ull;
  long long t0 = 0;
  for (unsigned i = 0;; ++i) {
    bool done = base != 0;
#pragma unroll
    for (int k = 0; k < K; ++k) done &= w[k] != 0;
    if (done) break;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (w[k] == 0) w[k] = ld_relaxed(agg + lo + lane + 32LL * k);
    if (base == 0) base = ld_relaxed(incl + (b - LB));
    if (i == 0) t0 = clock64();
    else if ((i & 1023) == 0 && clock64() - t0 > (1ll << 36)) __trap();
  }
  double sum = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) sum += decode(w[k]);
  // a butterfly: a + b == b + a, so every lane ends with the same bits
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  return (b >= LB ? decode(base) : carry) + sum;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_tiles(const T* __restrict__ x, T* __restrict__ out, long long n, int s,
           const float* __restrict__ carry_p, u64* __restrict__ ws,
           long long tiles) {
  constexpr int V = Vec<T>::N;          // elements a vector
  constexpr int TILE = NV * V;          // elements a tile
  __shared__ __align__(16) T tile_s[TILE];
  __shared__ float row_tot[K][WARPS];
  __shared__ long long tile_sh;
  __shared__ double excl_sh;
  u64* agg = ws + WS_HEAD;
  u64* incl = agg + tiles;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  if (threadIdx.x == 0)
    tile_sh = atomicAdd(reinterpret_cast<unsigned int*>(ws), 1u);
  __syncthreads();
  const long long b = tile_sh;

  // vector v of the tile holds elements base + v*V ...; a thread's
  // vectors are k*THREADS + threadIdx.x, so a warp's 16-byte copies
  // cover 512 contiguous bytes
  const long long base = b * TILE - s;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = k * THREADS + threadIdx.x;
    const long long i0 = base + (long long)v * V;
    T* d = tile_s + v * V;
    if (i0 >= 0 && i0 + V <= n) {
      cp_async16(d, x + i0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        d[e] = (i0 + e >= 0 && i0 + e < n) ? x[i0 + e] : from_f<T>(0.0f);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
  __syncthreads();

  // the tile in order (k, warp, lane, element): each vector's sum, each
  // row of 32 vectors scanned across its warp, then the rows in order
  float toff[K];   // exclusive prefix of the thread's vector in its row
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float f[V];
    unpack<T>(reinterpret_cast<const uint4*>(tile_s)[k * THREADS +
                                                     threadIdx.x], f);
    float inc = f[0];
#pragma unroll
    for (int e = 1; e < V; ++e) inc += f[e];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += u;
    }
    const float ex = __shfl_up_sync(0xffffffffu, inc, 1);
    toff[k] = lane == 0 ? 0.0f : ex;
    if (lane == 31) row_tot[k][warp] = inc;
  }
  __syncthreads();
  // toff[k] becomes the exclusive prefix of the vector in the tile: the
  // rows before (k, warp) plus its place in its row
  float total = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w == warp) toff[k] = total + toff[k];
      total += row_tot[k][w];
    }
  }
  if (threadIdx.x == 0) st_relaxed(agg + b, encode((double)total));
  if (warp == 0) {
    const double carry = carry_p ? (double)*carry_p : 0.0;
    const double e = look_back(agg, incl, b, carry, lane);
    if (lane == 0) {
      st_relaxed(incl + b, encode(e + (double)total));
      excl_sh = e;
    }
  }
  __syncthreads();
  const float ef = (float)excl_sh;

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int v = k * THREADS + threadIdx.x;
    float f[V];
    unpack<T>(reinterpret_cast<const uint4*>(tile_s)[v], f);
    const float t = toff[k];
    float o[V];
    float p = 0.0f;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      p = e == 0 ? f[0] : p + f[e];
      o[e] = ef + (t + p);
    }
    const long long i0 = base + (long long)v * V;
    if (i0 >= 0 && i0 + V <= n) {
      __stcs(reinterpret_cast<uint4*>(out + i0), pack<T>(o));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (i0 + e >= 0 && i0 + e < n) out[i0 + e] = from_f<T>(o[e]);
    }
  }
}

template <typename T>
int run(const void* x, void* out, long long n, const float* carry, u64* ws,
        long long nws, cudaStream_t stream) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(x) % 16;
  if (mis % sizeof(T) != 0 ||
      (reinterpret_cast<uintptr_t>(out) % 16) != mis)
    return (int)cudaErrorMisalignedAddress;
  const int s = (int)(mis / sizeof(T));
  constexpr long long TILE = TILE_BYTES / sizeof(T);
  const long long tiles = (n + s + TILE - 1) / TILE;
  if (nws < WS_HEAD + 2 * tiles || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  scan_tiles<T><<<(unsigned)tiles, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, s, carry, ws,
      tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = f16, 2 = bf16.  ws: nws zeroed 64-bit words, at
// least WS_HEAD + 2 * ceil((n + s) / tile), where a tile holds 32768
// bytes of x and s is x's offset in elements within 16 bytes.  out must
// share that offset.
extern "C" int dr_chunked_cumsum(const void* x, long long n, int dtype,
                                 const float* carry, void* ws, long long nws,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  u64* w = static_cast<u64*>(ws);
  switch (dtype) {
    case 0:
      return run<float>(x, out, n, carry, w, nws, s);
    case 1:
      return run<__half>(x, out, n, carry, w, nws, s);
    case 2:
      return run<__nv_bfloat16>(x, out, n, carry, w, nws, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
