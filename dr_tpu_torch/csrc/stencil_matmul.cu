// K1: composed-operator 1-D stencil apply for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the TPU kernel dr_tpu/ops/stencil_matmul.py:209
// (_pallas_apply, driven by matmul_stencil_row).  k steps of a radius-r
// stencil compose into one banded operator of 2R+1 taps c (R = k*r <= 512,
// composed in float64 on the host and rounded to f32).  Every owned cell
// becomes  out[o] = sum_{j=0}^{2R} c[j] * in[o - R + j].  Ghost cells are
// not written here; the wrapper copies them through stale.  Input and
// output are separate buffers: tiles read their neighbours' margins.
//
// Arithmetic: the TPU kernel's own, Precision.HIGH as three bf16 products
// (_bf16_split :125, _dot_high_split :140).  Taps and data split into bf16
// hi = rn(x) and lo = rn(x - hi); hi*hi + hi*lo + lo*hi accumulate in f32
// and lo*lo is dropped.  Each product is then off by ~2^-16 of itself,
// which averages out over a wide band but not over a few taps, so a
// narrow band (the wrapper's choice, by the taps' 2-norm) takes three
// parts (hi, mid, lo) and the six products of order below 3: f32-level.
// The host splits the taps; the kernel splits each data tile once, as it
// stages it.
//
// Bound on the H100: at k = 256, r = 2 the band has 1025 taps, so the
// three products take 3 x 2 x 1025 operations a cell: 6.68 ms at n = 2^30
// at the dense bf16 tensor-core rate (989 TFLOP/s), against a 2.56 ms
// memory floor.  Compute-bound, so the design is about keeping the tensor
// cores fed:
//   * lane blocking, the TPU's formulation: the row is read as rows of 64
//     cells, and output block j is sum_{d=-D..D} A_d X_{j+d}, D =
//     ceil(R / 64), with A_d[a][b] = c[64d + b - a + R] a 64 x 64 Toeplitz
//     block.  At R = 512 that is 17 terms of K = 64, 6% more products than
//     the band holds;
//   * the product is taken transposed, out^T = A_d X^T, on wgmma
//     m64n128k16: M = the 64 output lanes, N = 128 block rows a warpgroup,
//     K = the 64 lanes of the input block.  A, the operator, comes from
//     registers: each fragment is three 32-bit loads from a table of tap
//     pairs in shared memory (one table a part; the Toeplitz structure
//     makes neighbouring fragments share loads), so no dense operator is
//     built.  B, the data, is the staged tile in shared memory, one bf16
//     copy a part, K-major without swizzle in 8 planes: plane p holds
//     lanes 8p..8p+7 of every block row, 16 bytes a row, consecutive rows
//     adjacent.  Term d is then the same tile with its start moved d rows
//     (16 bytes): no copy per term;
//   * a tile is 256 block rows (16384 cells) plus D margin rows each side,
//     128 rows for each of two warpgroups.  Blocks are persistent, one per
//     SM, and walk the tiles.  One thread issues a 1-D bulk copy
//     (cp.async.bulk) of the next raw f32 tile, under an mbarrier, as soon
//     as the current one is split, so it lands under the current tile's
//     products; all 256 threads split a tile into the planes (16-byte
//     loads and 8-byte stores, free of bank conflicts: the plane stride is
//     16 bytes past a multiple of 128);
//   * each term d gathers its 12 (or 24) products, 4 k16 slices each, in
//     a fresh accumulator, added to the cell's f32 sum once they complete:
//     17 rounded additions a cell, not 204 into one accumulator.  While
//     one warpgroup waits and adds, the other's products keep the tensor
//     cores busy;
//   * results go from the registers straight to global memory: for each
//     register a warp writes 4 block rows x 8 consecutive lanes, whole
//     32-byte sectors.
// Determinism: a cell's bits depend only on its 2R+1 inputs and the taps:
// a fixed order over d, over the k16 slices and over the products, no
// atomics, no split of a cell's sum across blocks; the lane blocking
// starts at the owned start, so a cut at a 128-aligned offset keeps every
// cell's lane, and the tile boundaries do not enter.
// ptxas (sm_90a): 252 registers with two parts, no spills; 255 with
// three, 244 bytes spilled; dynamic shared memory 149,776 / 189,840 bytes
// at the widest band (R = 512).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LB = 64;              // cells a block row (wgmma's M)
constexpr int WG_ROWS = 128;        // block rows a warpgroup (wgmma's N)
constexpr int WGS = 2;              // consumer warpgroups
constexpr int THREADS = 128 * WGS;
constexpr int NT = WG_ROWS * WGS;   // block rows a tile
constexpr int DMAX = 8;             // R <= 512
constexpr int MROWS = NT + 2 * DMAX;         // staged rows at most
constexpr int RAW_BYTES = MROWS * LB * 4;    // the raw f32 stage
constexpr int PLANE = (MROWS + 1) * 16;      // 8 lanes of every row
constexpr int PART_BYTES = 8 * PLANE;        // one bf16 part of the tile
constexpr int TAP_OFF = 128;        // zero taps ahead of the band
constexpr int MAX_R = 512;
constexpr int MAX_TAPS = TAP_OFF + 2 * MAX_R + 136;  // the host's table

static_assert(PLANE % 128 == 16, "plane stride: conflict-free splits");

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
// 2^36 cycles (about 40 s: a lost copy or a phase fault) traps, so the
// launch fails rather than hanging the card
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

// `bytes` (a multiple of 16) from global to shared memory, completing on
// `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy shared-memory writes made visible to wgmma and the bulk
// copies (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a K-major shared-memory matrix descriptor without swizzle: core
// matrices of 8 rows x 16 bytes, `lbo` bytes to the next one along K,
// `sbo` to the next 8 rows
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the accumulator is read only after the wait: tie each register to it
__device__ __forceinline__ void hold(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D = (scale_d ? D : 0) + A B, A (bf16 pairs) from registers, B K-major in
// shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// `rows` block rows of the raw f32 stage into PARTS bf16 parts, each in
// its planes: part 0 = rn(x), part i = rn(x - parts 0..i-1) (each
// residual exact in f32); a thread takes 4 lanes of a row at a time
template <int PARTS>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* xs,
                                           int rows) {
  for (int i = threadIdx.x; i < rows * 16; i += THREADS) {
    const int q = i >> 4, c = i & 15;  // lanes 4c..4c+3
    float4 v = *reinterpret_cast<const float4*>(raw + q * 256 + c * 16);
    const int off = (c >> 1) * PLANE + q * 16 + (c & 1) * 8;
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      const __nv_bfloat162 b01 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 b23 = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(xs + p * PART_BYTES + off) =
          make_uint2(bits(b01), bits(b23));
      const float2 f01 = __bfloat1622float2(b01);
      const float2 f23 = __bfloat1622float2(b23);
      v = make_float4(v.x - f01.x, v.y - f01.y, v.z - f23.x, v.w - f23.y);
    }
  }
}

// the products of one k16 slice, largest first: tap part x data part
// over every pair whose order (the sum of the two part indices) is below
// PARTS; with 2 parts hi*hi, hi*lo, lo*hi (the TPU kernel's HIGH), with
// 3 parts also the three products of order 2
template <int PARTS>
struct Products;
template <>
struct Products<2> {  // (0, 0), (0, 1), (1, 0)
  static constexpr int N = 3;
  __device__ static constexpr int tap(int k) { return k == 2; }
  __device__ static constexpr int data(int k) { return k == 1; }
};
template <>
struct Products<3> {  // and (0, 2), (2, 0), (1, 1)
  static constexpr int N = 6;
  __device__ static constexpr int tap(int k) {
    return k == 2 || k == 5 ? 1 : k == 4 ? 2 : 0;
  }
  __device__ static constexpr int data(int k) {
    return k == 1 || k == 5 ? 1 : k == 3 ? 2 : 0;
  }
};

template <int PARTS>
__global__ void __launch_bounds__(THREADS, 1)
stencil_matmul_kernel(const float* __restrict__ in, float* __restrict__ out,
                      const uint16_t* __restrict__ taps, int ntaps,
                      long long halo, long long segrows, int R,
                      long long ntiles) {
  using P = Products<PARTS>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* xs = smem + RAW_BYTES;  // the parts' planes, part 0 first
  const int bar_off = RAW_BYTES + PARTS * PART_BYTES;
  uint32_t* pairs = reinterpret_cast<uint32_t*>(smem + bar_off + 16);
  const uint32_t bar = smem_u32(smem + bar_off);
  const int tid = threadIdx.x;
  const int D = (R + LB - 1) / LB;

  // tap pairs of each part: entry i holds taps i (low half) and i + 1
  for (int i = tid; i < PARTS * ntaps; i += THREADS) {
    const int col = i % ntaps;
    const uint32_t next = col + 1 < ntaps ? taps[i + 1] : 0;
    pairs[i] = taps[i] | (next << 16);
  }
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the raw stage <- block rows [row0 - D, row0 + rows + D) of tile t
  auto issue = [&](long long t) {
    const long long row0 = t * NT;
    const long long rows = (segrows - row0 < NT ? segrows - row0 : NT) + 2 * D;
    const uint32_t bytes = (uint32_t)(rows * LB * 4);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(smem), in + halo + (row0 - D) * LB, bytes, bar);
  };
  if (tid == 0 && blockIdx.x < ntiles) issue(blockIdx.x);

  const int wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nb = wg * WG_ROWS;  // the warpgroup's first block row
  // tap index of this thread's fragment entry (row g, column 2 t4) at
  // d = 0, k16 slice 0, less 8: fragment (d, s) of a part is Q[2s+1],
  // Q[2s], Q[2s+2], Q[2s+1] with Q[j] = pairs[base + 64 d + 8 j]
  const int base = TAP_OFF + R - 16 * w + 2 * t4 - g - 8;
  const uint32_t x0 = smem_u32(xs);

  int it = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++it) {
    const long long row0 = t * NT;
    const int nt = (int)(segrows - row0 < NT ? segrows - row0 : NT);
    mbar_wait(bar, it & 1);
    split_tile<PARTS>(smem, xs, nt + 2 * D);
    fence_async_smem();
    __syncthreads();
    // the stage is free: fetch the next tile into it under this one
    if (tid == 0 && t + gridDim.x < ntiles) issue(t + gridDim.x);

    if (nb < nt) {
      float sum[64], acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = acc[i] = 0.0f;
      for (int d = -D; d <= D; ++d) {
        uint32_t q[PARTS][9];
#pragma unroll
        for (int p = 0; p < PARTS; ++p)
#pragma unroll
          for (int j = 0; j < 9; ++j)
            q[p][j] = pairs[p * ntaps + base + 64 * d + 8 * j];
        const uint32_t row = (uint32_t)(nb + d + D) * 16;
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t off = row + 2 * s * PLANE;
#pragma unroll
          for (int k = 0; k < P::N; ++k) {
            const uint32_t* a = q[P::tap(k)];
            wgmma_rs(acc, a[2 * s + 1], a[2 * s], a[2 * s + 2], a[2 * s + 1],
                     desc(x0 + P::data(k) * PART_BYTES + off, PLANE, 128),
                     s > 0 || k > 0);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      }
      // register 4j + 2h + e holds lane 16w + g + 8h of block row
      // nb + 8j + 2 t4 + e
      float* dst = out + halo + (row0 + nb) * LB + 16 * w + g;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * j + 2 * t4 + e;
          if (nb + n < nt) {
            dst[n * LB] = sum[4 * j + e];
            dst[n * LB + 8] = sum[4 * j + 2 + e];
          }
        }
    }
    __syncthreads();  // both warpgroups are done with the planes
  }
}

template <int PARTS>
constexpr int smem_bytes(int ntaps) {
  return RAW_BYTES + PARTS * PART_BYTES + 16 + PARTS * ntaps * 4;
}

constexpr int MAX_DEV = 64;

template <int PARTS>
int launch(const float* in, float* out, const uint16_t* taps,
           long long halo, long long seg, int R, int ntaps,
           cudaStream_t stream) {
  static bool smem_set[MAX_DEV] = {};
  static int sms[MAX_DEV] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEV || !smem_set[dev]) {
    err = cudaFuncSetAttribute(stencil_matmul_kernel<PARTS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<PARTS>(MAX_TAPS));
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEV) smem_set[dev] = true;
  }
  int n_sm = dev < MAX_DEV ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEV) sms[dev] = n_sm;
  }
  const long long segrows = seg / LB;
  const long long ntiles = (segrows + NT - 1) / NT;
  const int grid = (int)(ntiles < n_sm ? ntiles : n_sm);
  stencil_matmul_kernel<PARTS>
      <<<grid, THREADS, smem_bytes<PARTS>(ntaps), stream>>>(
          in, out, taps, ntaps, halo, segrows, R, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: padded rows of halo + seg + halo f32 (in 16-byte aligned);
// taps: (parts, ntaps) bf16, the parts of the 2R+1 composed taps (2: the
// TPU kernel's hi and lo; 3: hi, mid, lo), each with TAP_OFF zeros ahead
// and zeros behind up to ntaps
extern "C" int dr_stencil_matmul(const float* in, float* out,
                                 const uint16_t* taps, long long halo,
                                 long long seg, long long width, int R,
                                 int ntaps, int parts, void* stream) {
  if (seg <= 0) return 0;
  if (R < 0 || R > MAX_R || seg % 128 != 0 || halo % 128 != 0 || halo < R ||
      width != 2 * halo + seg || ntaps < TAP_OFF + 2 * R + 127 ||
      ntaps > MAX_TAPS || (reinterpret_cast<uintptr_t>(in) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (parts == 2)
    return launch<2>(in, out, taps, halo, seg, R, ntaps,
                     (cudaStream_t)stream);
  if (parts == 3)
    return launch<3>(in, out, taps, halo, seg, R, ntaps,
                     (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
