// K1: composed-operator 1-D stencil apply for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/stencil_matmul.py:209
// (_pallas_apply, driven by matmul_stencil_row).  The TPU kernel applies
// k stencil steps at once as a banded Toeplitz operator on the MXU.  Here
// the same operator is applied as a direct banded sum: every owned cell
// becomes  out[o] = sum_{j=0}^{2R} c[j] * in[o - R + j]  with the 2R+1
// composed taps c (R = k*r, computed in float64 on the host, passed as
// f32).  Ghost cells are not written here; the wrapper copies them
// through stale.  Input and output are separate buffers: blocks read the
// ghost margins of their neighbours, so an in-place apply would race.
//
// Bound on the H100: at k=256, r=2 the band has 1025 taps, ~2050 FLOP per
// element, so the direct form is compute-bound on the fp32 CUDA cores
// (~33 ms per apply at n=2^30 against a 2.6 ms memory floor).  The design
// keeps the FMA units fed: each thread computes V consecutive outputs
// from a register window, so one shared-memory load feeds V FMAs, and the
// shared input tile is stored V-way transposed so that a warp's window
// loads hit 32 distinct banks.  Tensor cores (the TPU's choice) are the
// later step.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int V = 8;                 // outputs per thread
constexpr int TILE = THREADS * V;    // outputs per block

__device__ __forceinline__ int tidx(int q, int lv) {
  return (q % V) * lv + q / V;
}

__global__ void __launch_bounds__(THREADS)
stencil_matmul_kernel(const float* __restrict__ in, float* __restrict__ out,
                      const float* __restrict__ taps, long long halo,
                      long long seg, long long width, int R, int ntaps_pad,
                      int lv) {
  extern __shared__ float smem[];
  float* sc = smem;               // ntaps_pad composed taps (zero padded)
  float* sx = smem + ntaps_pad;   // input tile, V-way transposed
  const int t = threadIdx.x;
  const long long o0 = (long long)blockIdx.x * TILE;
  const long long g0 = halo + o0 - R;  // row position of tile element 0
  const int L = TILE + ntaps_pad;

  for (int j = t; j < ntaps_pad; j += THREADS) sc[j] = taps[j];
  for (int q = t; q < L; q += THREADS) {
    const long long g = g0 + q;
    sx[tidx(q, lv)] = (g >= 0 && g < width) ? in[g] : 0.0f;
  }
  __syncthreads();

  const int base = t * V;
  float acc[V];
  float buf[2 * V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    acc[i] = 0.0f;
    buf[i] = sx[i * lv + t];           // element base + i
  }
  for (int j0 = 0; j0 < ntaps_pad; j0 += V) {
    const int col = t + j0 / V + 1;    // (base + j0 + V) / V
#pragma unroll
    for (int k = 0; k < V; ++k) buf[V + k] = sx[k * lv + col];
#pragma unroll
    for (int jj = 0; jj < V; ++jj) {
      const float c = sc[j0 + jj];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(c, buf[i + jj], acc[i]);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) buf[k] = buf[V + k];
  }

  const long long o = o0 + base;
  if (o + V <= seg) {  // seg is a multiple of 128, so V outputs fit or none
    float4* dst = reinterpret_cast<float4*>(out + halo + o);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

}  // namespace

extern "C" int dr_stencil_matmul(const float* in, float* out,
                                 const float* taps, long long halo,
                                 long long seg, long long width, int R,
                                 int ntaps_pad, void* stream) {
  if (seg <= 0) return 0;
  int lv = (TILE + ntaps_pad) / V;
  lv += (36 - lv % 32) % 32;  // lv % 32 == 4: conflict-free tile stores
  const size_t smem = (ntaps_pad + (size_t)V * lv) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stencil_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nblk = (seg + TILE - 1) / TILE;
  stencil_matmul_kernel<<<(unsigned)nblk, THREADS, smem,
                          (cudaStream_t)stream>>>(in, out, taps, halo, seg,
                                                  width, R, ntaps_pad, lv);
  return (int)cudaGetLastError();
}
