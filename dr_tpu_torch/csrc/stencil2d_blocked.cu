// K5: temporally blocked 3x3 stencil with frozen edges, for Hopper (sm_90a).
//
// Replaces the TPU kernel dr_tpu/ops/stencil2d_pallas.py:48 (_build, driven
// by blocked_stencil2d_padded).  One launch steps the owned rows of a
// row-padded (m + 2*pad, n) f32 array T times (pad >= T, T <= 64) and
// writes them to a second array of the same layout; the wrapper copies the
// pad rows.  Interior cells (0 < row < m-1, 0 < col < n-1, logical
// coordinates) take the weighted 3x3 sum, a product and then FMAs in the
// order di, dj; edge rows and columns keep their value (Dirichlet), so pad
// rows never reach an owned cell.
//
// The TPU kernel keeps full-width row bands in VMEM; at n = 16384 one f32
// row is 64 KB, so Hopper tiles both dimensions.  Each tile is a window
// of WR x WC = 144 x 256 cells (a T-row margin above and below, a TP-column
// margin left and right, TP = T rounded up to a multiple of 4 so that the
// centre is 16-byte aligned); after T steps its centre, (WR - 2T) x
// (WC - 2TP) cells, is exact and written out.
//
//   * Cells live in registers across the T steps.  A block is 12 warps
//     stacked vertically; a thread owns a 12-row x 8-column patch (96
//     registers), a warp 12 rows x 256 columns.  Taps come from
//     registers: the rows above and below from the thread's own patch,
//     the left and right neighbours of a row's first and last cell by one
//     __shfl_sync each.  Only a warp's top and bottom rows cross to the
//     warps above and below, through shared memory: 16 floats written
//     and 16 read a thread a step for 96 cells, plus one row kept aside
//     (8 and 8), 2 B a cell-step where the earlier design moved 24 B (5
//     tap loads and a store) for the cross.
//   * The exchange is a split barrier: a warp publishes its old edge rows
//     and arrives on an mbarrier, steps its rows 1 .. R-2 (they need
//     nothing from other warps), and only then waits for its neighbours'
//     rows to step rows R-1 and 0.  Row 0 needs old row 1, which is kept
//     in shared memory for that.
//   * Loads overlap the steps.  The grid is persistent (one block an SM,
//     tiles walked in row-major order so concurrent tiles share their
//     margins in L2).  A TMA load over a 2-D tensor map of the padded
//     array brings the next tile's window into shared memory while the
//     block steps the current one in registers; its zero fill for boxes
//     past the array is the rule that rows outside the padded array and
//     columns outside [0, n) read 0 (they are never interior).  The centre
//     goes from registers to device memory with 16-byte stores.
//   * Recompute: every step computes the whole window (a warp whose rows
//     can no longer reach the centre cannot be skipped: the exchange
//     paces every warp), 1.47 cell-steps per owned cell-step at T = 16
//     (the earlier trapezoid 1.253, on shared memory), and 1.47 window
//     cells are read per owned cell (1.5625).
//   * Edges: a tile whose window reaches a frozen row or column steps
//     with a per-cell select that keeps frozen cells; the others (most)
//     step without one.
//
// Bound on the H100 at m = n = 16384, T = 16 with the heat weights: the
// function moves 2 x (m+2T) x n x 4 B = 2.15 GB (0.64 ms at 3.35 TB/s) and
// does 16 x 9 FLOP per interior cell (0.58 ms at 67 TFLOP/s): bytes-bound.
// This design's own floor is its issue rate: the step loop of a cross
// tile is ~574 instructions a warp for 96 cells (480 of them the multiply
// and 4 FMAs a cell), ~1.3 ms a pass on 132 SMs at ~1.75 GHz.  A zero
// weight among the template's taps adds 0*x, which leaves the sum
// unchanged for finite data.

#include <cuda.h>  // CUtensorMap and its enums; no driver library linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 12;            // warps a block, stacked vertically
constexpr int R = 12;             // rows a thread (and a warp)
constexpr int C = 8;              // columns a thread
constexpr int THREADS = NW * 32;
constexpr int WR = NW * R;        // window rows
constexpr int WC = 32 * C;        // window columns
constexpr int MAX_T = 64;         // WR - 2T and WC - 2TP stay positive
constexpr int BUF_BYTES = WR * WC * 4;
constexpr int XBUF_FLOATS = NW * 2 * WC;  // one ping-pong half
// shared memory: the window, the two exchange halves, a row a thread
// (`keep`), two mbarriers
constexpr int KEEP_OFF = BUF_BYTES + 2 * XBUF_FLOATS * 4;
constexpr int BAR_OFF = KEEP_OFF + THREADS * C * 4;
constexpr int SMEM_BYTES = BAR_OFF + 16;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Weights {
  float w[9];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed; a wait past
// 2^36 cycles (about 40 s: a lost load) traps, so the launch fails rather
// than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (uint32_t i = 0;; ++i) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (i == 0) t0 = clock64();
    else if ((i & 1023) == 0 && clock64() - t0 > (1ll << 36)) __trap();
  }
}

// one (WC x WR) box of the 2-D tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

struct Tile {
  long long r0, c0;  // logical row and column of window cell (0, 0)
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_c, int T, int TP) {
  const int OR = WR - 2 * T, OW = WC - 2 * TP;
  return {(long long)(t / tiles_c) * OR - T,
          (long long)(t % tiles_c) * OW - TP};
}

// the next state of one cell from its nine taps (the template's ones)
template <bool FULL>
__device__ __forceinline__ float cell(const float (&w)[9], float nw, float n,
                                      float ne, float we, float c, float e,
                                      float sw, float s, float se) {
  float acc;
  if (FULL) {
    acc = w[0] * nw;
    acc = fmaf(w[1], n, acc);
    acc = fmaf(w[2], ne, acc);
    acc = fmaf(w[3], we, acc);
    acc = fmaf(w[4], c, acc);
    acc = fmaf(w[5], e, acc);
    acc = fmaf(w[6], sw, acc);
    acc = fmaf(w[7], s, acc);
    acc = fmaf(w[8], se, acc);
  } else {
    acc = w[1] * n;
    acc = fmaf(w[3], we, acc);
    acc = fmaf(w[4], c, acc);
    acc = fmaf(w[5], e, acc);
    acc = fmaf(w[7], s, acc);
  }
  return acc;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void to_row(float (&r)[C], float4 a, float4 b) {
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

// The next state of one row of a thread's patch from the old rows above
// (up), at (cur) and below (dn), each with its left and right outer
// neighbours (the cells of the lanes beside).  MASK keeps frozen cells:
// all of them where `rok` is false, else those whose bit in colok is
// clear.
template <bool FULL, bool MASK>
__device__ __forceinline__ void row_step(float (&nu)[C], const float (&w)[9],
                                         const float (&up)[C], float ul,
                                         float ur, const float (&cur)[C],
                                         float cl, float cr,
                                         const float (&dn)[C], float dl,
                                         float dr, bool rok,
                                         unsigned colok) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float we = c > 0 ? cur[c - 1] : cl;
    const float e = c < C - 1 ? cur[c + 1] : cr;
    const float nw = c > 0 ? up[c - 1] : ul;
    const float ne = c < C - 1 ? up[c + 1] : ur;
    const float sw = c > 0 ? dn[c - 1] : dl;
    const float se = c < C - 1 ? dn[c + 1] : dr;
    nu[c] = cell<FULL>(w, nw, up[c], ne, we, cur[c], e, sw, dn[c], se);
    if (MASK && !(rok && ((colok >> c) & 1u))) nu[c] = cur[c];
  }
}

__device__ __forceinline__ float shl(float v) {  // the left lane's value
  return __shfl_up_sync(FULL_MASK, v, 1);
}
__device__ __forceinline__ float shr(float v) {  // the right lane's value
  return __shfl_down_sync(FULL_MASK, v, 1);
}

// Steps the window in registers T times.  A step publishes the warp's old
// top and bottom rows to xb ([half][warp][top, bottom][column half][lane]
// float4; `par` the half the next step writes) and arrives on the
// exchange barrier xbar (one arrival a warp), steps rows 1 .. R-2, which
// need nothing from other warps, then waits for the other warps' rows and
// steps rows R-1 and 0.  Row 0 needs old row 1, which the step has
// overwritten by then: it is kept in `keep` (shared memory, one slot a
// thread) rather than in registers.  MASK keeps cells frozen whose bit is
// clear in rowok (by row) or colok (by column).
template <bool FULL, bool MASK>
__device__ __forceinline__ void run_steps(float (&u)[R][C], float4* xb,
                                          float4* keep, uint32_t xbar,
                                          int& par, const float (&w)[9],
                                          int T, int warp, int lane,
                                          unsigned rowok, unsigned colok) {
  const int above = warp > 0 ? warp - 1 : 0;
  const int below = warp < NW - 1 ? warp + 1 : NW - 1;
  for (int s = 1; s <= T; ++s) {
    const int ph = par;
    float4* x = xb + ph * (XBUF_FLOATS / 4);
    par ^= 1;
    x[((warp * 2 + 0) * 2 + 0) * 32 + lane] =
        make_float4(u[0][0], u[0][1], u[0][2], u[0][3]);
    x[((warp * 2 + 0) * 2 + 1) * 32 + lane] =
        make_float4(u[0][4], u[0][5], u[0][6], u[0][7]);
    x[((warp * 2 + 1) * 2 + 0) * 32 + lane] =
        make_float4(u[R - 1][0], u[R - 1][1], u[R - 1][2], u[R - 1][3]);
    x[((warp * 2 + 1) * 2 + 1) * 32 + lane] =
        make_float4(u[R - 1][4], u[R - 1][5], u[R - 1][6], u[R - 1][7]);
    __syncwarp();
    if (lane == 0) mbar_arrive(xbar);
    keep[0] = make_float4(u[1][0], u[1][1], u[1][2], u[1][3]);
    keep[32] = make_float4(u[1][4], u[1][5], u[1][6], u[1][7]);

    // rows 1 .. R-2; prev: the old row above, with its outer neighbours
    float prev[C];
#pragma unroll
    for (int c = 0; c < C; ++c) prev[c] = u[0][c];
    float pl = FULL ? shl(prev[C - 1]) : 0.0f;
    float pr = FULL ? shr(prev[0]) : 0.0f;
    float cl = shl(u[1][C - 1]), cr = shr(u[1][0]);
#pragma unroll
    for (int r = 1; r < R - 1; ++r) {
      const float nl = shl(u[r + 1][C - 1]), nr = shr(u[r + 1][0]);
      float nu[C];
      row_step<FULL, MASK>(nu, w, prev, pl, pr, u[r], cl, cr, u[r + 1], nl,
                           nr, (rowok >> r) & 1u, colok);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        prev[c] = u[r][c];
        u[r][c] = nu[c];
      }
      pl = cl;
      pr = cr;
      cl = nl;
      cr = nr;
    }

    mbar_wait(xbar, ph);
    {  // row R-1: prev is old row R-2, (cl, cr) old row R-1's neighbours
      float dn[C];
      to_row(dn, x[((below * 2 + 0) * 2 + 0) * 32 + lane],
             x[((below * 2 + 0) * 2 + 1) * 32 + lane]);
      const float dl = FULL ? shl(dn[C - 1]) : 0.0f;
      const float dr = FULL ? shr(dn[0]) : 0.0f;
      float nu[C];
      row_step<FULL, MASK>(nu, w, prev, pl, pr, u[R - 1], cl, cr, dn, dl, dr,
                           (rowok >> (R - 1)) & 1u, colok);
#pragma unroll
      for (int c = 0; c < C; ++c) u[R - 1][c] = nu[c];
    }
    {  // row 0: the warp above's old bottom row, and old row 1 from keep
      float up[C], dn[C];
      to_row(up, x[((above * 2 + 1) * 2 + 0) * 32 + lane],
             x[((above * 2 + 1) * 2 + 1) * 32 + lane]);
      to_row(dn, keep[0], keep[32]);
      const float ul = FULL ? shl(up[C - 1]) : 0.0f;
      const float ur = FULL ? shr(up[0]) : 0.0f;
      const float dl = FULL ? shl(dn[C - 1]) : 0.0f;
      const float dr = FULL ? shr(dn[0]) : 0.0f;
      float nu[C];
      row_step<FULL, MASK>(nu, w, up, ul, ur, u[0], shl(u[0][C - 1]),
                           shr(u[0][0]), dn, dl, dr, rowok & 1u, colok);
#pragma unroll
      for (int c = 0; c < C; ++c) u[0][c] = nu[c];
    }
  }
}

template <bool FULL>
__global__ void __launch_bounds__(THREADS, 1)
stencil2d_kernel(const __grid_constant__ CUtensorMap map,
                 float* __restrict__ out, Weights wt, long long m,
                 long long n, int pad, int T, int TP, int tiles_c,
                 int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);
  float4* xb = reinterpret_cast<float4*>(smem + BUF_BYTES);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float4* keep = reinterpret_cast<float4*>(smem + KEEP_OFF) + warp * 64 +
                 lane;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  // bar: the window's TMA load; xbar: the exchange of edge rows
  const uint32_t bar = smem_u32(bars), xbar = smem_u32(bars + 1);
  const uint32_t dst = smem_u32(buf);
  int t = blockIdx.x;
  if (t >= tiles) return;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(xbar, NW);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const Tile f = tile_at(t, tiles_c, T, TP);
    mbar_expect_tx(bar, BUF_BYTES);
    tma_load(dst, &map, bar, (int)f.c0, (int)(f.r0 + pad));
  }
  __syncthreads();

  float w[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) w[k] = wt.w[k];
  const int OR = WR - 2 * T;
  // a thread reads its two 16-byte halves in an order that keeps each
  // quarter-warp on distinct banks
  const int hs = (lane >> 2) & 1;
  const float4* buf4 = reinterpret_cast<const float4*>(buf);
  uint32_t phase = 0;
  int par = 0;
  for (; t < tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, tiles_c, T, TP);
    mbar_wait(bar, phase);
    phase ^= 1;
    float u[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = (warp * R + r) * (WC / 4) + lane * 2;
      const float4 a = buf4[q + hs], b = buf4[q + (hs ^ 1)];
      const float4 lo = hs ? b : a, hi = hs ? a : b;
      u[r][0] = lo.x; u[r][1] = lo.y; u[r][2] = lo.z; u[r][3] = lo.w;
      u[r][4] = hi.x; u[r][5] = hi.y; u[r][6] = hi.z; u[r][7] = hi.w;
    }
    __syncthreads();  // the window is in registers: the buffer is free
    const int next = t + gridDim.x;
    if (threadIdx.x == 0 && next < tiles) {
      const Tile f = tile_at(next, tiles_c, T, TP);
      mbar_expect_tx(bar, BUF_BYTES);
      tma_load(dst, &map, bar, (int)f.c0, (int)(f.r0 + pad));
    }

    const bool inner = tl.r0 >= 1 && tl.r0 + WR <= m - 1 && tl.c0 >= 1 &&
                       tl.c0 + WC <= n - 1;
    if (inner) {
      run_steps<FULL, false>(u, xb, keep, xbar, par, w, T, warp, lane, 0u,
                             0u);
    } else {
      unsigned rowok = 0, colok = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long g = tl.r0 + warp * R + r;
        rowok |= (g >= 1 && g <= m - 2) ? 1u << r : 0u;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const long long g = tl.c0 + lane * C + c;
        colok |= (g >= 1 && g <= n - 2) ? 1u << c : 0u;
      }
      run_steps<FULL, true>(u, xb, keep, xbar, par, w, T, warp, lane,
                            rowok, colok);
    }

    // the centre: window rows [T, WR - T) below row m, columns
    // [TP, WC - TP) below column n, 16 bytes at a time
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = warp * R + r;
      const long long g = tl.r0 + k;
      if (k < T || k >= T + OR || g >= m) continue;
      float* row = out + (g + pad) * n + tl.c0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = lane * C + 4 * h;
        if (c0 >= TP && c0 + 4 <= WC - TP && tl.c0 + c0 + 4 <= n)
          *reinterpret_cast<float4*>(row + c0) =
              make_float4(u[r][4 * h], u[r][4 * h + 1], u[r][4 * h + 2],
                          u[r][4 * h + 3]);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int MAX_DEV = 64;

template <bool FULL>
int launch(const float* in, float* out, const Weights& wt, long long m,
           long long n, int pad, int T, cudaStream_t stream) {
  const int TP = (T + 3) & ~3;
  const long long tiles_c = (n + WC - 2 * TP - 1) / (WC - 2 * TP);
  const long long tiles_r = (m + WR - 2 * T - 1) / (WR - 2 * T);
  const long long rows = m + 2LL * pad;
  if (tiles_c * tiles_r > 0x7fffffffLL || n > 0x7fffffffLL ||
      rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t box[2] = {(cuuint32_t)WC, (cuuint32_t)WR};
  const cuuint32_t step[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(in), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  static bool smem_set[MAX_DEV];
  static int sms[MAX_DEV];
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(stencil2d_kernel<FULL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  const int tiles = (int)(tiles_c * tiles_r);
  const int grid = tiles < sms[dev] ? tiles : sms[dev];
  stencil2d_kernel<FULL><<<grid, THREADS, SMEM_BYTES, stream>>>(
      map, out, wt, m, n, pad, T, TP, (int)tiles_c, tiles);
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
  if (pad < tsteps || tsteps > MAX_T) return (int)cudaErrorInvalidValue;
  Weights wt;
  for (int k = 0; k < 9; ++k) wt.w[k] = weights[k];  // host array
  cudaStream_t s = (cudaStream_t)stream;
  return full ? launch<true>(in, out, wt, m, n, pad, tsteps, s)
              : launch<false>(in, out, wt, m, n, pad, tsteps, s);
}
