// K4: seeded inclusive add-scan for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/scan_pallas.py:244 (_build) and its
// auto-pipelined twin :198 (_build_grid), driven by chunked_cumsum.  The
// TPU kernel carries a running sum in SMEM across its sequential grid;
// Hopper runs blocks in no order, so this first form is reduce-then-scan
// in three launches:
//   1. block_totals  — each block sums its CHUNK of the input;
//   2. scan_totals   — one block scans the totals, seeded with the carry
//                      read from a device pointer (null means 0), giving
//                      every chunk its exclusive offset;
//   3. chunk_scan    — each block scans its CHUNK locally and adds its
//                      offset.
// All sums are f32 whatever the input type (f32, bf16, f16); the output
// has the input's type, as in the JAX kernel.
//
// Bound on the H100: the operation needs one read and one write, 8 bytes
// per f32 element (3.35 TB/s); this form reads the input twice, 12 bytes
// per element.  A single-pass decoupled look-back is the later step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 16;                 // elements per thread
constexpr int CHUNK = THREADS * PER;    // elements per block
constexpr int SCAN_THREADS = 1024;      // the totals scan block

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

// padded shared index: a thread's PER consecutive elements spread banks
__device__ __forceinline__ int pidx(int i) { return i + i / 32; }

// Exclusive scan of one value per thread across an NT-thread block (NT a
// multiple of 32, at most 1024); *total gets the block's sum.  Warp
// prefixes come from shuffles, the warp offsets from warp 0; exclusive
// values are shifted inclusive ones, never an inclusive minus the value.
template <int NT>
__device__ __forceinline__ float block_scan_excl(float v, float* total) {
  __shared__ float warp_tot[NT / 32];
  __shared__ float warp_off[NT / 32];
  __shared__ float block_tot;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w = lane < NT / 32 ? warp_tot[lane] : 0.0f;
    float wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += u;
    }
    float we = __shfl_up_sync(0xffffffffu, wi, 1);
    if (lane == 0) we = 0.0f;
    if (lane < NT / 32) warp_off[lane] = we;
    if (lane == 31) block_tot = wi;
  }
  __syncthreads();
  *total = block_tot;
  const float r = warp_off[warp] + excl;
  __syncthreads();  // the shared slots are reused by the next call
  return r;
}

__device__ __forceinline__ float block_sum(float v) {
  float total;
  block_scan_excl<THREADS>(v, &total);
  return total;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_totals(const T* __restrict__ x, long long n, float* __restrict__ totals) {
  const long long base = (long long)blockIdx.x * CHUNK;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < CHUNK; i += THREADS) {
    const long long g = base + i;
    if (g < n) acc += to_f(x[g]);
  }
  const float tot = block_sum(acc);
  if (threadIdx.x == 0) totals[blockIdx.x] = tot;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_totals(const float* __restrict__ totals, long long nb,
            const float* __restrict__ carry_p, float* __restrict__ offsets) {
  float running = carry_p ? *carry_p : 0.0f;
  for (long long b0 = 0; b0 < nb; b0 += SCAN_THREADS) {
    const long long i = b0 + threadIdx.x;
    const float v = i < nb ? totals[i] : 0.0f;
    float tot;
    const float ex = block_scan_excl<SCAN_THREADS>(v, &tot);
    if (i < nb) offsets[i] = running + ex;
    running += tot;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chunk_scan(const T* __restrict__ x, long long n,
           const float* __restrict__ offsets, T* __restrict__ out) {
  __shared__ float s[CHUNK + CHUNK / 32];
  const long long base = (long long)blockIdx.x * CHUNK;
  for (int i = threadIdx.x; i < CHUNK; i += THREADS) {
    const long long g = base + i;
    s[pidx(i)] = g < n ? to_f(x[g]) : 0.0f;
  }
  __syncthreads();
  float p[PER];
  const int first = threadIdx.x * PER;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    acc += s[pidx(first + k)];
    p[k] = acc;
  }
  float tot;
  const float toff = block_scan_excl<THREADS>(acc, &tot);
  const float off = offsets[blockIdx.x] + toff;
#pragma unroll
  for (int k = 0; k < PER; ++k) s[pidx(first + k)] = off + p[k];
  __syncthreads();
  for (int i = threadIdx.x; i < CHUNK; i += THREADS) {
    const long long g = base + i;
    if (g < n) out[g] = from_f<T>(s[pidx(i)]);
  }
}

template <typename T>
int run(const T* x, long long n, const float* carry, float* totals,
        float* offsets, T* out, cudaStream_t s) {
  const long long nb = (n + CHUNK - 1) / CHUNK;
  block_totals<T><<<(unsigned)nb, THREADS, 0, s>>>(x, n, totals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_totals<<<1, SCAN_THREADS, 0, s>>>(totals, nb, carry, offsets);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_scan<T><<<(unsigned)nb, THREADS, 0, s>>>(x, n, offsets, out);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = f16, 2 = bf16.  totals and offsets each hold
// nscratch floats, at least ceil(n / CHUNK).
extern "C" int dr_chunked_cumsum(const void* x, long long n, int dtype,
                                 const float* carry, float* totals,
                                 float* offsets, long long nscratch,
                                 void* out, void* stream) {
  if (n <= 0) return 0;
  if (nscratch < (n + CHUNK - 1) / CHUNK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return run<float>((const float*)x, n, carry, totals, offsets,
                        (float*)out, s);
    case 1:
      return run<__half>((const __half*)x, n, carry, totals, offsets,
                         (__half*)out, s);
    case 2:
      return run<__nv_bfloat16>((const __nv_bfloat16*)x, n, carry, totals,
                                offsets, (__nv_bfloat16*)out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
