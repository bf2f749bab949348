// K5: temporally blocked 3x3 stencil with frozen edges, for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/stencil2d_pallas.py:48 (_build, driven
// by blocked_stencil2d_padded).  One launch steps the owned rows of a
// row-padded (m + 2*pad, n) f32 array T times (pad >= T) and writes them to
// a second array of the same layout; the wrapper copies the pad rows.
// Interior cells (0 < row < m-1, 0 < col < n-1, logical coordinates) take
// the weighted 3x3 sum in the order di, dj; edge rows and columns keep
// their value (Dirichlet), so pad rows never reach an owned cell.
//
// The TPU kernel keeps full-width row bands in VMEM.  At n = 16384 one f32
// row is 64 KB, so a Hopper block cannot hold even four.  This kernel tiles
// both dimensions instead: each block loads a (B+2T) x (B+2T) window (a
// T-wide margin on all four sides; rows outside the padded array and
// columns outside [0, n) load as 0 and are never interior), steps T times
// ping-ponging between two shared-memory buffers, and writes the B x B
// centre.  Step s computes only the cells the remaining steps still need,
// the window shrunk by s+1 on every side (the trapezoid), so nothing
// wraps: the TPU kernel's rolls become index offsets.  Both buffers start
// equal, so cells that are not interior never need writing.
//
// Tile: B = 128 for T <= 21 (two 160x160 f32 buffers = 200 KB at T = 16),
// halved while two (B+2T)^2 buffers exceed the 227 KB a block may use, down
// to B = 32 (T <= 64; the wrapper splits longer passes).  The cost is
// recompute: at B = 128, T = 16 the trapezoid computes 1.253 cell-steps per
// owned cell-step (sum_k (128+2k)^2 / (16*128^2), k = 0..15), and each block
// reads 1.5625 window cells per owned cell from device memory (the overlap
// between neighbouring windows is read again, mostly from L2).
//
// Bound on the H100 at m = n = 16384, T = 16 with the heat weights: the
// function moves 2 x (m+2T) x n x 4 B = 2.15 GB (0.64 ms at 3.35 TB/s) and
// does 16 x 7 FLOP per interior cell (0.45 ms at 67 TFLOP/s): bytes-bound.
// This design's own floor is shared memory: every computed cell-step loads
// its 5 (cross) or 9 (full) taps and stores one value, 24 B for the cross,
// against ~33 TB/s of shared-memory bandwidth (128 B/clk on 132 SMs), so
// ~3.9 ms per pass with the 1.253 recompute.  Register windows that reuse
// taps between neighbouring cells are the next step; products contract to
// FMAs (a zero weight among the template's taps adds 0*x, which leaves the
// sum unchanged for finite data).

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 32;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use

struct Weights {
  float w[9];
};

__host__ __device__ inline long long lmax(long long a, long long b) {
  return a > b ? a : b;
}
__host__ __device__ inline long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

template <bool FULL>
__global__ void __launch_bounds__(TX * TY, 1)
stencil2d_kernel(const float* __restrict__ in, float* __restrict__ out,
                 Weights wt, long long m, long long n, int pad, int T,
                 int B) {
  extern __shared__ float smem[];
  const int W = B + 2 * T;
  float* a = smem;
  float* b = smem + W * W;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // logical coordinates of window cell (0, 0)
  const long long gr0 = (long long)blockIdx.y * B - T;
  const long long gc0 = (long long)blockIdx.x * B - T;
  const long long rows = m + 2LL * pad;

  for (int r = ty; r < W; r += TY) {
    const long long pr = gr0 + r + pad;  // padded row
    const bool rok = pr >= 0 && pr < rows;
    for (int c = tx; c < W; c += TX) {
      const long long gc = gc0 + c;
      const float v = (rok && gc >= 0 && gc < n) ? in[pr * n + gc] : 0.0f;
      a[r * W + c] = v;
      b[r * W + c] = v;
    }
  }

  float w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = wt.w[k];
  // interior cells of the window: rows [rmin, rmax), cols [cmin, cmax)
  const int rmin = (int)lmax(1 - gr0, 0), rmax = (int)lmin(m - 1 - gr0, W);
  const int cmin = (int)lmax(1 - gc0, 0), cmax = (int)lmin(n - 1 - gc0, W);
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int rl = max(s + 1, rmin), rh = min(W - s - 1, rmax);
    const int cl = max(s + 1, cmin), ch = min(W - s - 1, cmax);
    for (int r = rl + ty; r < rh; r += TY) {
      for (int c = cl + tx; c < ch; c += TX) {
        const float* p = a + r * W + c;
        float acc;
        if (FULL) {
          acc = w[0] * p[-W - 1];
          acc = fmaf(w[1], p[-W], acc);
          acc = fmaf(w[2], p[-W + 1], acc);
          acc = fmaf(w[3], p[-1], acc);
          acc = fmaf(w[4], p[0], acc);
          acc = fmaf(w[5], p[1], acc);
          acc = fmaf(w[6], p[W - 1], acc);
          acc = fmaf(w[7], p[W], acc);
          acc = fmaf(w[8], p[W + 1], acc);
        } else {
          acc = w[1] * p[-W];
          acc = fmaf(w[3], p[-1], acc);
          acc = fmaf(w[4], p[0], acc);
          acc = fmaf(w[5], p[1], acc);
          acc = fmaf(w[7], p[W], acc);
        }
        b[r * W + c] = acc;
      }
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }

  for (int r = T + ty; r < T + B; r += TY) {
    const long long gr = gr0 + r;
    if (gr >= m) break;
    for (int c = T + tx; c < T + B; c += TX) {
      const long long gc = gc0 + c;
      if (gc < n) out[(gr + pad) * n + gc] = a[r * W + c];
    }
  }
}

template <bool FULL>
int launch(const float* in, float* out, const Weights& wt, long long m,
           long long n, int pad, int T, cudaStream_t stream) {
  int B = 128;
  while (B > 32 && 2LL * (B + 2 * T) * (B + 2 * T) * 4 > SMEM_MAX) B /= 2;
  const long long smem = 2LL * (B + 2 * T) * (B + 2 * T) * 4;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      stencil2d_kernel<FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + B - 1) / B), (unsigned)((m + B - 1) / B));
  stencil2d_kernel<FULL><<<grid, dim3(TX, TY), (size_t)smem, stream>>>(
      in, out, wt, m, n, pad, T, B);
  return (int)cudaGetLastError();
}

}  // namespace

// weights: 9 host floats, row-major 3x3; full != 0 uses all nine taps,
// full == 0 the cross (the four corner weights must be zero).
extern "C" int dr_stencil2d_blocked(const float* in, float* out,
                                    const float* weights, int full,
                                    long long m, long long n, int pad,
                                    int tsteps, void* stream) {
  if (m <= 0 || n <= 0 || tsteps <= 0) return 0;
  if (pad < tsteps) return (int)cudaErrorInvalidValue;
  Weights wt;
  for (int k = 0; k < 9; ++k) wt.w[k] = weights[k];  // host array
  cudaStream_t s = (cudaStream_t)stream;
  return full ? launch<true>(in, out, wt, m, n, pad, tsteps, s)
              : launch<false>(in, out, wt, m, n, pad, tsteps, s);
}
