// K2: temporally blocked 1-D weighted stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/stencil_pallas.py:89 (_build, driven
// by blocked_stencil_row).  Each block stages its tile of owned cells plus
// a T*r margin on each side in shared memory, steps T times ping-ponging
// between two shared buffers (the margin shrinks by r per step, the
// trapezoid of the TPU kernel), then writes the trusted core.  The TPU
// kernel's lane and sublane rolls become plain index offsets.  Ghost cells
// are not written here; the wrapper copies them through stale.
//
// Each step computes  acc = x[i-r]*w[0];  acc = acc + x[i-r+d]*w[d]  with
// separately rounded products and sums (no FMA contraction), the order of
// the JAX kernel and of the plain PyTorch version, so the kernel is
// bit-identical to the plain version.
//
// Bound on the H100: at T=64, r=2 a pass does ~576 FLOP per element
// against 8 bytes of device memory, so it is compute-bound (~9 ms per pass
// at n=2^30 on the fp32 units, against a 2.6 ms memory floor).  This form
// cannot reach that: without FMA contraction each cell-step issues 2r+1
// multiplies and 2r adds, each at half the FMA FLOP rate, and every step
// recomputes the whole (TILE + 2*T*r)-cell buffer, 12.5% more than the
// tile, so its floor is ~21 ms per pass.  Going below needs FMAs, which
// give up bit-identity with the plain version.  Whether shared-memory
// loads (2r+1 per cell and step) hold it above that floor has not been
// profiled.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;  // owned cells per block
constexpr int MAXR = 8;

struct Weights {
  float w[2 * MAXR + 1];
};

template <int RAD>
__global__ void __launch_bounds__(THREADS)
blocked_kernel(const float* __restrict__ in, float* __restrict__ out,
               long long halo, long long seg, long long width, int tsteps,
               Weights wt) {
  extern __shared__ float smem[];
  const int M = tsteps * RAD;       // trapezoid margin
  const int L = TILE + 2 * M;
  float* a = smem;
  float* b = smem + L;
  const int t = threadIdx.x;
  const long long o0 = (long long)blockIdx.x * TILE;
  const long long g0 = halo + o0 - M;

  for (int q = t; q < L; q += THREADS) {
    const long long g = g0 + q;
    const float v = (g >= 0 && g < width) ? in[g] : 0.0f;
    a[q] = v;
    b[q] = v;
  }
  __syncthreads();

  float w[2 * RAD + 1];
#pragma unroll
  for (int d = 0; d <= 2 * RAD; ++d) w[d] = wt.w[d];

  for (int s = 0; s < tsteps; ++s) {
    for (int i = RAD + t; i < L - RAD; i += THREADS) {
      float acc = __fmul_rn(a[i - RAD], w[0]);
#pragma unroll
      for (int d = 1; d <= 2 * RAD; ++d)
        acc = __fadd_rn(acc, __fmul_rn(a[i - RAD + d], w[d]));
      b[i] = acc;
    }
    __syncthreads();
    float* tmp = a;
    a = b;
    b = tmp;
  }

  for (int q = t; q < TILE; q += THREADS) {
    const long long o = o0 + q;
    if (o < seg) out[halo + o] = a[M + q];
  }
}

template <int RAD>
int launch(const float* in, float* out, long long halo, long long seg,
           long long width, int tsteps, const Weights& wt,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)(TILE + 2 * tsteps * RAD) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blocked_kernel<RAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nblk = (seg + TILE - 1) / TILE;
  blocked_kernel<RAD><<<(unsigned)nblk, THREADS, smem, stream>>>(
      in, out, halo, seg, width, tsteps, wt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dr_stencil_blocked(const float* in, float* out,
                                  const float* weights, int radius,
                                  long long halo, long long seg,
                                  long long width, int tsteps,
                                  void* stream) {
  if (seg <= 0 || tsteps <= 0) return 0;
  if (radius < 1 || radius > MAXR) return (int)cudaErrorInvalidValue;
  Weights wt;
  for (int d = 0; d <= 2 * radius; ++d) wt.w[d] = weights[d];  // host array
  cudaStream_t s = (cudaStream_t)stream;
  switch (radius) {
    case 1: return launch<1>(in, out, halo, seg, width, tsteps, wt, s);
    case 2: return launch<2>(in, out, halo, seg, width, tsteps, wt, s);
    case 3: return launch<3>(in, out, halo, seg, width, tsteps, wt, s);
    case 4: return launch<4>(in, out, halo, seg, width, tsteps, wt, s);
    case 5: return launch<5>(in, out, halo, seg, width, tsteps, wt, s);
    case 6: return launch<6>(in, out, halo, seg, width, tsteps, wt, s);
    case 7: return launch<7>(in, out, halo, seg, width, tsteps, wt, s);
    default: return launch<8>(in, out, halo, seg, width, tsteps, wt, s);
  }
}
