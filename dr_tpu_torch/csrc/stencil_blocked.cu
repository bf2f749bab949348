// K2: temporally blocked 1-D weighted stencil for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/stencil_pallas.py:89 (_build, driven
// by blocked_stencil_row).  One launch steps the owned cells
// [halo, halo + seg) of one padded f32 row T times and writes them to a
// second row; ghost cells are not written here (the wrapper copies them
// through stale).  Reads outside [0, width) give 0; they never reach an
// owned cell, since halo >= T*r.
//
// Each step computes  acc = x[i-r]*w[0];  acc = acc + x[i-r+d]*w[d]  with
// separately rounded products and sums (no FMA contraction), the order of
// the JAX kernel and of the plain PyTorch version, so the output equals
// the plain version's bit for bit.
//
// Bound on the H100: at T=64, r=2 a pass does 576 FLOP per element
// against 8 bytes of device memory, so it is compute-bound (9.2 ms at
// n=2^30 counting 67 TFLOP/s).  Without FMAs each cell-step issues 2r+1
// multiplies and 2r adds, one instruction each, so this form's floor is
// 9 instructions a cell-step at 128 lanes a clock an SM: ~18.5 ms at
// 1.98 GHz.  Going below needs FMAs, which give up the bits.  The
// window route's step loop issues ~315 instructions a thread a step at
// r=2 for 32 cells (288 of them the multiplies and adds) with 1.032
// cell-steps per owned one, so its own floor is ~20.9 ms.
//
// The window route (most calls):
//   * A block holds a window of W = 256 threads x 32 contiguous cells in
//     registers across the T steps: a margin of M = T*r rounded up to 4
//     cells on each side and a centre of W - 2M cells, exact after T
//     steps and written out (7936 cells at T=64, r=2: 1.032 cell-steps
//     per owned one).  Blocks are placed on multiples of the centre width.
//   * Taps come from the thread's own registers; the r cells past each end
//     of a thread's run from lanes -1 and +1 by one shuffle each.  Only a
//     warp's lane 0 (its left r cells) and lane 31 (its right r cells)
//     cross to the neighbouring warps, through shared memory: 2r floats a
//     warp a step, where a tile in shared memory moves 2r+2 accesses a
//     cell-step and the shared-memory pipe, not the fp32 units, sets the
//     pace (the earlier design of this file, kept below).
//   * The exchange is split around the block's barrier: a warp publishes
//     its old edge cells, steps the cells that need nothing from other
//     warps, and only then meets the others at the barrier to step its
//     first and last r cells (the old values those need stay in
//     registers: a step writes a second array).  Two steps an iteration,
//     so the new array of one step is the old of the next without copies.
//     An mbarrier arrival and wait in place of the barrier issued more
//     instructions and ran ~2% slower.
//   * The window comes in and the centre goes out through shared memory,
//     with coalesced 16-byte accesses on the device side and an XOR
//     swizzle that keeps a thread's 16-byte chunks on distinct banks.
//     Two blocks an SM: one block's load and store run under the other's
//     steps.
//
// The shared-memory route: when the margin is deeper than W/4 (T*r above
// 2048) the window's centre would fall below half of it, and the block
// takes the earlier trapezoid instead: a 2048-cell tile plus the margin
// in shared memory, stepped T times ping-ponging between two buffers.
// Rows whose pointers, halo, seg or width are not 16-byte multiples take
// it as well.  Both routes count as one stencil_blocked launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXR = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Weights {
  float w[2 * MAXR + 1];
};

// ---------------------------------------------------------------- window

constexpr int NW = 8;                 // warps a block
constexpr int C = 32;                 // contiguous cells a thread
constexpr int THREADS = NW * 32;
constexpr int W = THREADS * C;        // window cells
constexpr int CH = C / 4;             // 16-byte chunks a thread
constexpr int MIN_BLOCKS = 512 / THREADS;  // 16 warps an SM
constexpr int MAX_MARGIN = W / 4;

// the shared slot of 16-byte chunk j of thread t: chunks XOR-swizzled
// within the thread's 128 bytes, so that the 8 threads of a quarter-warp
// reading their chunk j hit 8 different bank groups
__device__ __forceinline__ int slot(int t, int j) {
  return t * CH + (j ^ (t & (CH - 1)));
}

// window cell c + i of a thread whose cells are u, with the r cells
// before them in lf and the r after them in rt (i is known at compile
// time once the loops are unrolled)
template <int RAD>
__device__ __forceinline__ float tap(const float (&u)[C],
                                     const float (&lf)[RAD],
                                     const float (&rt)[RAD], int i) {
  return i < 0 ? lf[i + RAD] : (i >= C ? rt[i - C] : u[i]);
}

template <int RAD>
__device__ __forceinline__ float cell(const float (&u)[C],
                                      const float (&lf)[RAD],
                                      const float (&rt)[RAD], int c,
                                      const float (&w)[2 * RAD + 1]) {
  float acc = __fmul_rn(tap<RAD>(u, lf, rt, c - RAD), w[0]);
#pragma unroll
  for (int d = 1; d <= 2 * RAD; ++d)
    acc = __fadd_rn(acc, __fmul_rn(tap<RAD>(u, lf, rt, c - RAD + d), w[d]));
  return acc;
}

// One step of a thread's cells, u (old) to nu (new).  x is this step's
// half of the exchange, [warp][left, right][cell]: the warp publishes its
// old edge cells there, steps the cells that need nothing from other
// warps, and only then meets the other warps at the block's barrier to
// step its first and last r cells.  The empty asm statements pin that
// order: without them the compiler hoists the inner cells above the
// publication, and the barrier follows it with nothing between.
template <int RAD>
__device__ __forceinline__ void step(float (&u)[C], float (&nu)[C],
                                     float (*x)[2][RAD], int lane,
                                     int warp, int left, int right,
                                     const float (&w)[2 * RAD + 1]) {
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < RAD; ++k) x[warp][0][k] = u[k];
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < RAD; ++k) x[warp][1][k] = u[C - RAD + k];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) asm volatile("" : "+f"(u[c]));
  float lf[RAD], rt[RAD];
#pragma unroll
  for (int k = 0; k < RAD; ++k) {
    lf[k] = __shfl_up_sync(FULL_MASK, u[C - RAD + k], 1);
    rt[k] = __shfl_down_sync(FULL_MASK, u[k], 1);
  }
#pragma unroll
  for (int c = RAD; c < C - RAD; ++c) {
    nu[c] = cell<RAD>(u, lf, rt, c, w);
    asm volatile("" : "+f"(nu[c]));
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < RAD; ++k) {
    const float a = x[left][1][k], b = x[right][0][k];
    lf[k] = lane == 0 ? a : lf[k];
    rt[k] = lane == 31 ? b : rt[k];
  }
#pragma unroll
  for (int c = 0; c < RAD; ++c) {
    nu[c] = cell<RAD>(u, lf, rt, c, w);
    nu[C - RAD + c] = cell<RAD>(u, lf, rt, C - RAD + c, w);
  }
}

template <int RAD>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
window_kernel(const float* __restrict__ in, float* __restrict__ out,
              long long halo, long long seg, long long width, int tsteps,
              int M, Weights wt) {
  __shared__ float4 stage[W / 4];
  // [step parity][warp][left, right][cell]: a warp's old edge cells
  __shared__ float xb[2][NW][2][RAD];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const long long o0 = (long long)blockIdx.x * (W - 2 * M);
  const long long g0 = halo + o0 - M;  // row index of window cell 0

  const float4* in4 = reinterpret_cast<const float4*>(in);
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int q = k * THREADS + t;  // the window's 16-byte chunk q
    const long long g = g0 + 4LL * q;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (g >= 0 && g < width) v = in4[g / 4];
    stage[slot(q / CH, q % CH)] = v;
  }
  __syncthreads();
  float u[C];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const float4 v = stage[slot(t, j)];
    u[4 * j] = v.x;
    u[4 * j + 1] = v.y;
    u[4 * j + 2] = v.z;
    u[4 * j + 3] = v.w;
  }

  float w[2 * RAD + 1];
#pragma unroll
  for (int d = 0; d <= 2 * RAD; ++d) w[d] = wt.w[d];
  // the warps beside (a window end takes its own warp's edge: the cells
  // it feeds lie in the margin)
  const int left = warp > 0 ? warp - 1 : 0;
  const int right = warp < NW - 1 ? warp + 1 : NW - 1;
  // two steps an iteration, so that the new cells of one are the old of
  // the next without copies; step s uses exchange half s % 2 (a warp
  // writes a half again only after every warp has passed the barrier of
  // the step between, and so read it)
  float nu[C];
  int s = 0;
  for (; s + 2 <= tsteps; s += 2) {
    step<RAD>(u, nu, xb[0], lane, warp, left, right, w);
    step<RAD>(nu, u, xb[1], lane, warp, left, right, w);
  }
  if (s < tsteps) {
    step<RAD>(u, nu, xb[0], lane, warp, left, right, w);
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = nu[c];
  }

  // the centre, window cells [M, W - M) below seg, 16 bytes at a time; a
  // thread's own slots are read by it alone, so they are free
#pragma unroll
  for (int j = 0; j < CH; ++j)
    stage[slot(t, j)] =
        make_float4(u[4 * j], u[4 * j + 1], u[4 * j + 2], u[4 * j + 3]);
  __syncthreads();
  float4* out4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int k = 0; k < CH; ++k) {
    const int q = k * THREADS + t;
    const long long o = o0 + 4LL * q - M;  // owned cell of its first value
    if (4 * q >= M && 4 * q < W - M && o < seg)
      out4[(halo + o) / 4] = stage[slot(q / CH, q % CH)];
  }
}

// ----------------------------------------------------------- shared memory

constexpr int SH_THREADS = 256;
constexpr int TILE = 2048;  // owned cells per block

template <int RAD>
__global__ void __launch_bounds__(SH_THREADS)
shared_kernel(const float* __restrict__ in, float* __restrict__ out,
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

  for (int q = t; q < L; q += SH_THREADS) {
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
    for (int i = RAD + t; i < L - RAD; i += SH_THREADS) {
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

  for (int q = t; q < TILE; q += SH_THREADS) {
    const long long o = o0 + q;
    if (o < seg) out[halo + o] = a[M + q];
  }
}

template <int RAD>
int launch(const float* in, float* out, long long halo, long long seg,
           long long width, int tsteps, const Weights& wt,
           cudaStream_t stream) {
  const long long M = ((long long)tsteps * RAD + 3) & ~3LL;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0 &&
      (halo & 3) == 0 && (seg & 3) == 0 && (width & 3) == 0;
  if (aligned && M <= MAX_MARGIN) {
    const long long nblk = (seg + W - 2 * M - 1) / (W - 2 * M);
    if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    window_kernel<RAD><<<(unsigned)nblk, THREADS, 0, stream>>>(
        in, out, halo, seg, width, tsteps, (int)M, wt);
    return (int)cudaGetLastError();
  }
  const size_t smem =
      2 * (size_t)(TILE + 2 * (long long)tsteps * RAD) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shared_kernel<RAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nblk = (seg + TILE - 1) / TILE;
  shared_kernel<RAD><<<(unsigned)nblk, SH_THREADS, smem, stream>>>(
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
