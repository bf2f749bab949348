// stencil_step: one weighted 1-D stencil step over one padded f32 row, in
// one pass over the row.
//
// Replaces no TPU kernel.  The JAX package's plain step
// (dr_tpu/algorithms/stencil.py, the shifted-slice multiply-and-add of
// _step_rows) is one XLA loop fusion; the port ran it as 2r+1 multiplies
// and 2r adds of torch ops, each reading and writing a temporary of the
// whole row, around whole-row clones of the in and out rows.
//
// One launch writes the stepped cells [lo, hi) of a fresh out row y from
// the in row x.  A cell the step reads outside x's valid owned cells
// [hprev, vend) comes from the exchange's received ghost slices where the
// caller passes them: gp (ghost_prev, cell j at gp[j]) and gn (ghost_next,
// cell j at gn[j - vend]); else from x's own ghosts.  x is never written.
// The caller copies the cells outside [lo, hi) through from the old out
// row.
//
// Each output is  acc = x[i-r]*w[0];  acc = acc + x[i-r+d]*w[d]  with
// separately rounded products and sums (no FMA contraction), the order of
// the torch ops, so the output equals the plain version bit for bit.
//
// Bound on the H100: 2r+1 multiplies and 2r adds a cell against 8 bytes
// of device memory (one read, one write): 1.1 operations a byte at r = 2,
// far below the fp32 ridge of 20 (67 TFLOP/s over 3.35 TB/s), so the pass
// is bound by memory, 2.564 ms at 2^30 cells.  The design is a streaming
// pass that moves those 8 bytes a cell and nothing else:
//   * A warp steps a tile of 256 cells on the row's own 16-byte grid
//     (tile t holds row cells [256t, 256t + 256)), each lane 8 contiguous
//     cells by two 16-byte loads and, where all 8 are stepped, two 16-byte
//     stores.  The owned range's offset (8 bytes at halo 2) costs nothing:
//     only the tiles at the two ends of [lo, hi) are partial.
//   * The r cells past a lane's run come from lanes -1 and +1 by one
//     shuffle each; lanes 0 and 31 read the r cells past the tile (lines
//     the neighbouring warps load at the same time, so L1 or L2 hits).
//     No shared memory.
//   * One tile a warp, blocks of 8 warps over all the tiles; the store
//     streams (evict-first), the new row is not read in this pass.  A
//     persistent grid of 4 blocks an SM striding over the tiles, with one
//     or two tiles a warp in flight, ran 13-19% slower (2^30 cells: 3.19-
//     3.42 ms against 2.83).
//   * A tile whose reads leave [hprev, vend) (the row's two ends), or a
//     row not on 16 bytes, takes the scalar route: each lane steps its
//     cells from single loads, the ghost slices included, in the same
//     order and so with the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXR = 8;
constexpr int C = 8;                // contiguous cells a lane
constexpr int TILE = 32 * C;        // cells a warp steps at a time
constexpr int WARPS = 8;            // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int BLOCKS_PER_SM = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Weights {
  float w[2 * MAXR + 1];
};

struct Row {
  const float* x;    // the in row
  const float* gp;   // received ghost_prev, or null
  const float* gn;   // received ghost_next, or null
  float* y;          // the fresh out row
  long long hprev;   // first owned cell
  long long vend;    // one past the last valid owned cell
  long long lo, hi;  // the cells stepped
  long long t0;      // first tile
  long long ntiles;  // tiles over [lo, hi)
  int vec;           // x and y on 16 bytes
};

// cell j of the exchanged row
__device__ __forceinline__ float fetch(const Row& g, long long j) {
  if (j < g.hprev && g.gp) return __ldg(g.gp + j);
  if (j >= g.vend && g.gn) return __ldg(g.gn + (j - g.vend));
  return __ldg(g.x + j);
}

// the tile's reads all lie in the valid owned cells, on 16 bytes
template <int R>
__device__ __forceinline__ bool interior(const Row& g, long long tb) {
  return g.vec && tb - R >= g.hprev && tb + TILE + R <= g.vend;
}

// a lane's 8 cells into v[R, R + 8)
template <int R>
__device__ __forceinline__ void load(const Row& g, long long base,
                                     float (&v)[C + 2 * R]) {
  const float4* p = reinterpret_cast<const float4*>(g.x + base);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  v[R + 0] = a.x; v[R + 1] = a.y; v[R + 2] = a.z; v[R + 3] = a.w;
  v[R + 4] = b.x; v[R + 5] = b.y; v[R + 6] = b.z; v[R + 7] = b.w;
}

// the r cells on each side, the step, and the store of a loaded tile
template <int R>
__device__ __forceinline__ void finish(const Row& g, long long base,
                                       int lane, float (&v)[C + 2 * R],
                                       const Weights& w) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    // lane - 1's cell C - R + k and lane + 1's cell k
    float l = __shfl_up_sync(FULL_MASK, v[C + k], 1);
    float h = __shfl_down_sync(FULL_MASK, v[R + k], 1);
    if (lane == 0) l = __ldg(g.x + base - R + k);
    if (lane == 31) h = __ldg(g.x + base + C + k);
    v[k] = l;
    v[R + C + k] = h;
  }
  float o[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = __fmul_rn(v[c], w.w[0]);
#pragma unroll
    for (int d = 1; d <= 2 * R; ++d)
      acc = __fadd_rn(acc, __fmul_rn(v[c + d], w.w[d]));
    o[c] = acc;
  }
  if (base >= g.lo && base + C <= g.hi) {
    // streaming stores: the new row is not read again in this pass
    float4* q = reinterpret_cast<float4*>(g.y + base);
    __stcs(q, make_float4(o[0], o[1], o[2], o[3]));
    __stcs(q + 1, make_float4(o[4], o[5], o[6], o[7]));
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (base + c >= g.lo && base + c < g.hi) g.y[base + c] = o[c];
  }
}

template <int R>
__device__ void scalar_tile(const Row& g, long long base, const Weights& w) {
  for (int c = 0; c < C; ++c) {
    const long long j = base + c;
    if (j < g.lo || j >= g.hi) continue;
    float acc = __fmul_rn(fetch(g, j - R), w.w[0]);
#pragma unroll
    for (int d = 1; d <= 2 * R; ++d)
      acc = __fadd_rn(acc, __fmul_rn(fetch(g, j - R + d), w.w[d]));
    g.y[j] = acc;
  }
}

// one tile a warp; every branch is warp-uniform
template <int R>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
stencil_step_kernel(const Row g, const Weights w) {
  const long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= g.ntiles) return;
  const int lane = threadIdx.x & 31;
  const long long tb = (g.t0 + t) * TILE;
  if (interior<R>(g, tb)) {
    float v[C + 2 * R];
    load<R>(g, tb + lane * C, v);
    finish<R>(g, tb + lane * C, lane, v, w);
  } else {
    scalar_tile<R>(g, tb + lane * C, w);
  }
}

template <int R>
int launch(const Row& g, const Weights& w, cudaStream_t s) {
  const long long nblk = (g.ntiles + WARPS - 1) / WARPS;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stencil_step_kernel<R><<<(unsigned)nblk, THREADS, 0, s>>>(g, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Step cells [lo, hi) of the row x (owned cells from hprev, valid ones up
// to vend) into y with the 2 * radius + 1 weights (host memory); gp / gn
// the received ghost slices or null.  Returns cudaGetLastError().
extern "C" int dr_stencil_step(const float* x, const float* gp,
                               const float* gn, float* y,
                               const float* weights, int radius,
                               long long hprev, long long vend, long long lo,
                               long long hi, void* stream) {
  if (radius < 1 || radius > MAXR || hprev < radius || lo < hprev ||
      hi > vend || lo >= hi)
    return (int)cudaErrorInvalidValue;
  Row g;
  g.x = x;
  g.gp = gp;
  g.gn = gn;
  g.y = y;
  g.hprev = hprev;
  g.vend = vend;
  g.lo = lo;
  g.hi = hi;
  g.t0 = lo / TILE;
  g.ntiles = (hi - 1) / TILE - g.t0 + 1;
  g.vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)y % 16 == 0);
  Weights w = {};
  for (int i = 0; i < 2 * radius + 1; ++i) w.w[i] = weights[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch<1>(g, w, s);
    case 2: return launch<2>(g, w, s);
    case 3: return launch<3>(g, w, s);
    case 4: return launch<4>(g, w, s);
    case 5: return launch<5>(g, w, s);
    case 6: return launch<6>(g, w, s);
    case 7: return launch<7>(g, w, s);
    default: return launch<8>(g, w, s);
  }
}
