// K3: streamed dot product  sum(x * (y + salt))  for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/reduce_pallas.py:64 (_build, driven
// by chunked_dot).  The TPU kernel folds every chunk into one SMEM
// accumulator across its sequential grid; Hopper runs blocks in no order,
// so the sum takes two stages: a fixed grid of blocks writes one f32
// partial each into a scratch tensor, then a one-block launch sums the
// partials.  No float atomics: the grid and the summation order are fixed,
// so a result is the same from run to run.  Inputs are f32, bf16 or f16
// and accumulate in f32; ``salt`` is read from a device pointer (null
// means 0), so a loop feeding each round's result back as the next salt
// never waits for the host.
//
// Bound on the H100: read-only, 8 bytes per element for f32 (4 for the
// 16-bit types) against ~2 FLOP, so memory-bound (3.35 TB/s).  The design
// streams with 16-byte loads for f32 and keeps ~8 blocks per SM in flight.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // valid in thread 0
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dot_partials(const T* __restrict__ x, const T* __restrict__ y, long long n,
             const float* __restrict__ salt_p, float* __restrict__ partials) {
  const float salt = salt_p ? *salt_p : 0.0f;
  const long long stride = (long long)gridDim.x * THREADS;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride)
    acc += to_f(x[i]) * (to_f(y[i]) + salt);
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// f32 specialization: 16-byte loads (n a multiple of 4, aligned pointers)
__global__ void __launch_bounds__(THREADS)
dot_partials_f32x4(const float4* __restrict__ x, const float4* __restrict__ y,
                   long long n4, const float* __restrict__ salt_p,
                   float* __restrict__ partials) {
  const float salt = salt_p ? *salt_p : 0.0f;
  const long long stride = (long long)gridDim.x * THREADS;
  float acc = 0.0f;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += stride) {
    const float4 a = x[i], b = y[i];
    acc += a.x * (b.x + salt);
    acc += a.y * (b.y + salt);
    acc += a.z * (b.z + salt);
    acc += a.w * (b.w + salt);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(THREADS)
sum_partials(const float* __restrict__ partials, int nparts,
             float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += THREADS) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

}  // namespace

// dtype: 0 = f32, 1 = f16, 2 = bf16.  partials holds nparts floats.
extern "C" int dr_chunked_dot(const void* x, const void* y, long long n,
                              int dtype, const float* salt, float* partials,
                              int nparts, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  if (dtype == 0 && vec) {
    dot_partials_f32x4<<<nparts, THREADS, 0, s>>>(
        (const float4*)x, (const float4*)y, n / 4, salt, partials);
  } else if (dtype == 0) {
    dot_partials<float><<<nparts, THREADS, 0, s>>>(
        (const float*)x, (const float*)y, n, salt, partials);
  } else if (dtype == 1) {
    dot_partials<__half><<<nparts, THREADS, 0, s>>>(
        (const __half*)x, (const __half*)y, n, salt, partials);
  } else if (dtype == 2) {
    dot_partials<__nv_bfloat16><<<nparts, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)y, n, salt,
        partials);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_partials<<<1, THREADS, 0, s>>>(partials, nparts, out);
  return (int)cudaGetLastError();
}
