// K9: one ring step's flash-attention update of the running (m, l, acc)
// state, for Hopper (sm_90a).
//
// Replaces the TPU kernels dr_tpu/ops/flash_attention.py:242 (_build, the
// whole K/V block resident in VMEM) and :150 (_build_streaming, K/V tiles
// streamed over a grid axis), driven by flash_update :334.  Their math is
// _block_update :105: for each K/V tile, logits = (q . k) * (1/sqrt(d)) as
// bf16 products summed in f32, the causal mask by GLOBAL positions
// (q_off + row >= k_off + col), new_m = max(m, rowmax), safe_m = new_m where
// it is > -inf else 0, p = exp(logits - safe_m), corr = exp(m - safe_m),
// l = l * corr + rowsum(p) (f32 p), acc = acc * corr + bf16(p) . v.
//
// Bound on the H100: 2 * BH * s * skv * d operations for the ideal causal
// triangle (twice that non-causal) at 989 TFLOP/s dense bf16, against
// reading q, k, v and the state once and writing the state once at
// 3.35 TB/s: operations-bound at long context, so the design is about
// keeping the tensor cores fed.
//
// Design for d = 128 and d = 256 (flash_update_hopper), the head dims of
// the public models:
//   * persistent: one block per SM (at most), each walking a linear index
//     over (128-row q tile, q head), the last q tiles (the heaviest under
//     the causal mask) first.  Nothing is on grid y, so any number of
//     heads runs;
//   * warp specialised, 384 threads: two consumer warpgroups of 64 q rows
//     each (setmaxnreg 240) and a producer warpgroup (setmaxnreg 24) in
//     which one thread issues TMA loads (cp.async.bulk.tensor, 128-byte
//     swizzle) of Q once per tile and of K and V into a 2-stage ring.  K
//     and V each have a "full" (transaction bytes) and an "empty" (256
//     consumer arrivals) mbarrier per stage, so a K tile is released as
//     soon as S has read it and a V tile when PV has;
//   * K/V tiles of 128 keys at d = 128 (Q 32 KB + 2 x 64 KB = 160 KB of
//     shared memory) and of 64 keys at d = 256 (64 KB + 2 x 64 KB = 192 KB);
//   * S = Q K^T on wgmma m64nBKk16 with both operands K-major in shared
//     memory (Q stays there for the whole tile); acc += bf16(p) V on
//     wgmma m64n128k16 with A from registers: the f32 S accumulator's
//     layout is the A fragment layout, so p is rounded to bf16 in
//     registers, and V, row-major in its tile, is the MN-major B operand
//     (the transpose bit), so nothing transposes it;
//   * software pipelined: S(kt) and PV(kt - 1) are issued together and
//     the softmax of tile kt runs while PV(kt - 1) is on the tensor cores
//     (1.6% faster on the H100 than waiting for each product; a ping-pong
//     of the two warpgroups on named barriers was 11% slower and a third
//     stage at d = 128 changed nothing: tools/k9_probe.py, in turns);
//   * the online softmax in f32 registers with the reference's rules; m is
//     exactly the max of the f32 logit * scale; p and corr are exp2f of
//     (x - safe_m) * log2(e) (one MUFU op; x - safe_m is the reference's
//     own difference, so only the product's rounding is added, within l's
//     1e-5 limit);
//   * causal: K tiles past the q tile's last global position are never
//     loaded; only the tiles reaching past its first position are masked
//     element by element.  A tile with no K tile left (a block wholly in
//     the future) copies its (m, l, acc) rows to the outputs;
//   * m, l and acc are read into registers at the start of a tile and
//     written once at its end; acc stays f32, the carried state.
// ptxas (sm_90a, CUDA 12.9): 168 registers at entry for every kernel of
// this source (the 384-thread bound; setmaxnreg then moves the producer's
// to the consumers), no spills; dynamic shared memory 164,944 bytes at
// d = 128 and 197,712 at d = 256 (Smem<D>::BYTES, slack included).
//
// d >= 384 (flash_update_wide, the first design): one block per (64-row q
// tile, q head, 128-column chunk of d), 4 warps of 16 rows, mma.sync
// m16n8k16, 64-key tiles with K row-major and V transposed in shared
// memory (53 KB whatever d is), Q and K staged 128 columns of d at a time;
// launched over chunks of at most 65535 q heads (grid y).  It is chosen by
// d in dr_flash_update, not on any failure.

#include <cuda.h>  // CUtensorMap and its enums; no driver library linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------ d >= 384 (mma.sync)

constexpr int BQ = 64;          // q rows per block, 16 per warp
constexpr int BK = 64;          // keys per K/V tile
constexpr int DC = 128;         // acc columns per block
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;          // bf16 per shared row: conflict-free loads
constexpr int LDC = DC + PAD;   // row stride of the Q and K chunks
constexpr int LDV = BK + PAD;   // row stride of the transposed V tile
constexpr int VECS = DC / 8;    // 16-byte vectors in a chunk's row
// shared memory of a block: the Q and K chunks and V^T, 53,248 bytes
constexpr size_t SMEM = ((size_t)(BQ + BK) * LDC + (size_t)DC * LDV) * 2;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(THREADS, 3)
flash_update_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const float* __restrict__ acc_in,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int s, int skv, int d,
                    int group, long long q_off, long long k_off, int causal,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);      // BQ x LDC, one d chunk
  bf16* Ks = Qs + BQ * LDC;                      // BK x LDC, one d chunk
  bf16* Vt = Ks + BK * LDC;                      // DC x LDV (V^T)

  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int bh = blockIdx.y;
  const int dc = blockIdx.z * DC;                // first acc column
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;        // fragment row / column
  const int wr = warp * 16;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};

  const bf16* qb = q + (long long)bh * s * d;
  const bf16* kb = k + (long long)(bh / group) * skv * d;
  const bf16* vb = v + (long long)(bh / group) * skv * d;
  const long long st = (long long)bh * s;        // first state row

  // columns c0.. of the Q tile, rows past s zero (never stored)
  auto load_q = [&](int c0) {
    for (int i = tid; i < BQ * VECS; i += THREADS) {
      const int r = i / VECS, c = (i % VECS) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < s)
        val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * d +
                                              c0 + c);
      *reinterpret_cast<uint4*>(Qs + r * LDC + c) = val;
    }
  };
  const int nch = d / DC;                        // 128-column chunks of d
  if (nch == 1) load_q(0);                       // resident for every tile

  float m_r[2], l_r[2];
  float o[DC / 8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < s;
    m_r[h] = in ? m_in[st + rows[h]] : -INFINITY;
    l_r[h] = in ? l_in[st + rows[h]] : 0.f;
#pragma unroll
    for (int nt = 0; nt < DC / 8; ++nt) {
      float2 a = make_float2(0.f, 0.f);
      if (in)
        a = *reinterpret_cast<const float2*>(
            acc_in + (st + rows[h]) * d + dc + nt * 8 + 2 * t4);
      o[nt][2 * h] = a.x;
      o[nt][2 * h + 1] = a.y;
    }
  }

  // K tiles that can attend: causal stops after the tile holding the q
  // tile's last global position
  const int nk = skv / BK;
  int hi = nk;
  if (causal) {
    const long long last = q_off + (long long)min(q0 + BQ, s) - 1 - k_off;
    hi = last < 0 ? 0 : (int)min((long long)nk, last / BK + 1);
  }

  for (int kt = 0; kt < hi; ++kt) {
    // S = Q K^T: the warp's 16 rows x BK keys, summed over the d chunks
    float sc[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();                           // last reads of Qs/Ks/Vt done
      if (nch > 1) load_q(ch * DC);
      const bf16* kp = kb + (long long)kt * BK * d + ch * DC;
      for (int i = tid; i < BK * VECS; i += THREADS) {
        const int r = i / VECS, c = (i % VECS) * 8;
        *reinterpret_cast<uint4*>(Ks + r * LDC + c) =
            *reinterpret_cast<const uint4*>(kp + (long long)r * d + c);
      }
      if (ch == 0) {
        // V^T: neighbouring threads take neighbouring keys, so the scalar
        // transposed stores of a warp land in distinct words
        const bf16* vp = vb + (long long)kt * BK * d + dc;
        for (int i = tid; i < BK * VECS; i += THREADS) {
          const int r = i % BK, c = (i / BK) * 8;
          const uint4 val =
              *reinterpret_cast<const uint4*>(vp + (long long)r * d + c);
          const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
          for (int j = 0; j < 8; ++j) Vt[(c + j) * LDV + r] = e[j];
        }
      }
      __syncthreads();
      for (int kk = 0; kk < DC; kk += 16) {
        const bf16* qa = Qs + (wr + g) * LDC + kk + 2 * t4;
        const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * LDC),
                               ld_pair(qa + 8), ld_pair(qa + 8 * LDC + 8)};
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          const bf16* kq = Ks + (nt * 8 + g) * LDC + kk + 2 * t4;
          mma_bf16(sc[nt], a, ld_pair(kq), ld_pair(kq + 8));
        }
      }
    }

    // scale, mask, row max
    const long long k0 = k_off + (long long)kt * BK;
    float bmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = sc[nt][e] * scale;
        if (causal && q_off + rows[h] < k0 + nt * 8 + 2 * t4 + (e & 1))
          x = -INFINITY;
        sc[nt][e] = x;
        bmax[h] = fmaxf(bmax[h], x);
      }
    }
    float safe[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float nm = fmaxf(m_r[h], quad_max(bmax[h]));
      safe[h] = nm > -INFINITY ? nm : 0.f;
      corr[h] = expf(m_r[h] - safe[h]);          // m = -inf -> 0
      m_r[h] = nm;
    }

    // p = exp(logits - safe_m); the S fragments become the A fragments of
    // the PV product: keys 16*kk.. are n-tiles 2kk (a0, a1), 2kk+1 (a2, a3)
    uint32_t pa[BK / 16][4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float p0 = expf(sc[nt][0] - safe[0]);
      const float p1 = expf(sc[nt][1] - safe[0]);
      const float p2 = expf(sc[nt][2] - safe[1]);
      const float p3 = expf(sc[nt][3] - safe[1]);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2] = pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * corr[h] + quad_sum(ps[h]);
#pragma unroll
    for (int nt = 0; nt < DC / 8; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }

    // acc += bf16(p) V: B fragments from V^T, pairs along the keys
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < DC / 8; ++nt) {
        const bf16* vq = Vt + (nt * 8 + g) * LDV + kk * 16 + 2 * t4;
        mma_bf16(o[nt], pa[kk], ld_pair(vq), ld_pair(vq + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (rows[h] >= s) continue;
    if (dc == 0 && t4 == 0) {
      m_out[st + rows[h]] = m_r[h];
      l_out[st + rows[h]] = l_r[h];
    }
#pragma unroll
    for (int nt = 0; nt < DC / 8; ++nt)
      *reinterpret_cast<float2*>(acc_out + (st + rows[h]) * d + dc + nt * 8 +
                                 2 * t4) =
          make_float2(o[nt][2 * h], o[nt][2 * h + 1]);
  }
}

// ------------------------------------------------ d = 128 and d = 256

constexpr int HBQ = 128;        // q rows per tile: two consumer warpgroups
constexpr int PANEL = 64;       // bf16 columns per 128-byte swizzled panel
constexpr int CONSUMERS = 256;  // threads of the two consumer warpgroups
constexpr int HTHREADS = 384;   // and one producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;

// keys per K/V tile and stages of the K/V ring, by head dim
template <int D> struct Tiles;
template <> struct Tiles<128> { static constexpr int BK = 128, STAGES = 2; };
template <> struct Tiles<256> { static constexpr int BK = 64, STAGES = 2; };

// shared memory: Q (128 rows), then per stage K and V (BK rows), each
// stored as D / 64 panels of 64 columns (128-byte rows, swizzled by TMA),
// then the barriers; 1024 bytes of slack align the swizzle atoms
template <int D> struct Smem {
  static constexpr int BK = Tiles<D>::BK, STAGES = Tiles<D>::STAGES;
  static constexpr int NP = D / PANEL;
  static constexpr int Q_PANEL = HBQ * 128, KV_PANEL = BK * 128;
  static constexpr int Q_BYTES = NP * Q_PANEL, KV_BYTES = NP * KV_PANEL;
  static constexpr int KV_OFF = Q_BYTES;
  static constexpr int BAR_OFF = KV_OFF + STAGES * 2 * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + (4 * STAGES + 2) * 8 + 1024;
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed; a wait past
// 2^36 cycles (about 40 s: a lost load or a phase fault) traps, so the
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

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// a shared-memory matrix descriptor for wgmma, 128-byte swizzle
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S (+)= A B^T, A and B K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (+)= A B^T, A and B K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B, A (bf16 pairs) from registers, B MN-major in shared memory
// (the transpose bit, 128-byte swizzle)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// work item w of nq * BH: the last (heaviest causal) q tiles first
__device__ __forceinline__ void work_item(int w, int BH, int nq, int& q0,
                                          int& bh) {
  q0 = (nq - 1 - w / BH) * HBQ;
  bh = w % BH;
}

// K tiles a q tile attends: causal stops after the tile holding the q
// tile's last global position
__device__ __forceinline__ int k_tiles(int q0, int s, int nk, int bk,
                                       int causal, long long q_off,
                                       long long k_off) {
  if (!causal) return nk;
  const long long last = q_off + (long long)min(q0 + HBQ, s) - 1 - k_off;
  return last < 0 ? 0 : (int)min((long long)nk, last / bk + 1);
}

template <int D>
struct Consumer {
  static constexpr int BK = Tiles<D>::BK, NC = D / 128;

  // S = Q K^T for the warpgroup's 64 rows x BK keys, both operands K-major;
  // a k16 step inside a 64-column panel moves the start by 32 bytes
  static __device__ __forceinline__ void qk(float (&sc)[BK / 2], uint32_t q,
                                            uint32_t k) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = kk / 4, byte = (kk % 4) * 32;
      const uint64_t da = sw128(q + col * Smem<D>::Q_PANEL + byte, 16, 1024);
      const uint64_t db = sw128(k + col * Smem<D>::KV_PANEL + byte, 16, 1024);
      if constexpr (BK == 128)
        wgmma_ss_n128(sc, da, db, kk > 0);
      else
        wgmma_ss_n64(sc, da, db, kk > 0);
    }
  }

  // acc += bf16(p) V: V is the MN-major B operand (the transpose bit); LBO
  // steps 64 columns of d (a panel), SBO 8 keys, a k16 step 16 keys
  static __device__ __forceinline__ void pv(float (&o)[NC][64],
                                            const uint32_t (&pa)[BK / 16][4],
                                            uint32_t v) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_rs_n128(o[c], pa[kk],
                      sw128(v + 2 * c * Smem<D>::KV_PANEL + kk * 2048,
                            Smem<D>::KV_PANEL, 1024));
  }

  // the online softmax of one tile of logits (rows r and r + 8 of the
  // thread): scale, mask (only a tile reaching past the q tile's first
  // position, `diag`), row max, corr, l, and p as the bf16 A fragments of
  // the PV product (keys 16kk.. are n8 blocks 2kk: a0, a1; 2kk+1: a2, a3)
  static __device__ __forceinline__ void softmax(
      float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4], float (&m_r)[2],
      float (&l_r)[2], float (&corr)[2], float scale, bool diag,
      long long qpos, long long k0, int t4) {
    float bmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = sc[4 * j + e] * scale;
        if (diag && qpos + 8 * h < k0 + 8 * j + 2 * t4 + (e & 1))
          x = -INFINITY;
        sc[4 * j + e] = x;
        bmax[h] = fmaxf(bmax[h], x);
      }
    float safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float nm = fmaxf(m_r[h], quad_max(bmax[h]));
      safe[h] = nm > -INFINITY ? nm : 0.f;
      corr[h] = exp2f((m_r[h] - safe[h]) * LOG2E);  // m = -inf -> 0
      m_r[h] = nm;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = exp2f((sc[4 * j] - safe[0]) * LOG2E);
      const float p1 = exp2f((sc[4 * j + 1] - safe[0]) * LOG2E);
      const float p2 = exp2f((sc[4 * j + 2] - safe[1]) * LOG2E);
      const float p3 = exp2f((sc[4 * j + 3] - safe[1]) * LOG2E);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * corr[h] + quad_sum(ps[h]);
  }

  static __device__ __forceinline__ void rescale(float (&o)[NC][64],
                                                 const float (&corr)[2]) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[c][4 * j] *= corr[0];
        o[c][4 * j + 1] *= corr[0];
        o[c][4 * j + 2] *= corr[1];
        o[c][4 * j + 3] *= corr[1];
      }
  }
};

// the A fragments stay untouched until the product reading them is done
template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
flash_update_hopper(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const float* __restrict__ acc_in,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ acc_out, int BH, int s, int skv,
                    int group, long long q_off, long long k_off, int causal,
                    float scale) {
  using L = Smem<D>;
  using C = Consumer<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES, NP = L::NP, NC = D / 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  // barriers: K full, V full, K empty, V empty (one of each per stage),
  // then Q full and Q empty
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t q_full = bars + 32 * STAGES, q_empty = q_full + 8;
  auto k_full = [&](int st) { return bars + 8 * st; };
  auto v_full = [&](int st) { return bars + 8 * (STAGES + st); };
  auto k_empty = [&](int st) { return bars + 8 * (2 * STAGES + st); };
  auto v_empty = [&](int st) { return bars + 8 * (3 * STAGES + st); };
  auto k_tile = [&](int st) { return base + L::KV_OFF + st * 2 * L::KV_BYTES; };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);  // one arrival with the TMA bytes
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), CONSUMERS);
      mbar_init(v_empty(st), CONSUMERS);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nq = (s + HBQ - 1) / HBQ, nk = skv / BK;
  const int items = nq * BH;

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the TMA loads in flight,
    // in the order the consumers use them: K(kt), [Q], V(kt)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      int st = 0;
      uint32_t ph = 0, qph = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        int q0, bh;
        work_item(w, BH, nq, q0, bh);
        const int hi = k_tiles(q0, s, nk, BK, causal, q_off, k_off);
        const int kvh = bh / group;
        for (int kt = 0; kt < hi; ++kt) {
          const uint32_t kdst = k_tile(st), vdst = kdst + L::KV_BYTES;
          mbar_wait(k_empty(st), ph ^ 1);
          mbar_expect_tx(k_full(st), L::KV_BYTES);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            tma_load(kdst + p * L::KV_PANEL, &tk, k_full(st), p * PANEL,
                     kt * BK, kvh);
          if (kt == 0) {
            mbar_wait(q_empty, qph ^ 1);
            mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
            for (int p = 0; p < NP; ++p)
              tma_load(sQ + p * L::Q_PANEL, &tq, q_full, p * PANEL, q0, bh);
            qph ^= 1;
          }
          mbar_wait(v_empty(st), ph ^ 1);
          mbar_expect_tx(v_full(st), L::KV_BYTES);
#pragma unroll
          for (int p = 0; p < NP; ++p)
            tma_load(vdst + p * L::KV_PANEL, &tv, v_full(st), p * PANEL,
                     kt * BK, kvh);
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 q rows each.  Software pipelined:
    // S(kt) and PV(kt - 1) go to the tensor cores together, and the
    // softmax of tile kt runs while PV(kt - 1) is still in flight
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t sQw = sQ + wg * 64 * 128;  // the warpgroup's 64 Q rows
    int st = 0;
    uint32_t ph = 0, qph = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      int q0, bh;
      work_item(w, BH, nq, q0, bh);
      const int hi = k_tiles(q0, s, nk, BK, causal, q_off, k_off);
      const int r0 = q0 + wg * 64 + warp * 16 + g;  // rows r0 and r0 + 8
      const long long st0 = (long long)bh * s;       // first state row

      float m_r[2], l_r[2];
      float o[NC][64];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const bool in = r < s;
        m_r[h] = in ? m_in[st0 + r] : -INFINITY;
        l_r[h] = in ? l_in[st0 + r] : 0.f;
        const float* ap = acc_in + (st0 + r) * D + 2 * t4;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            float2 a = make_float2(0.f, 0.f);
            if (in) a = *reinterpret_cast<const float2*>(ap + c * 128 + 8 * j);
            o[c][4 * j + 2 * h] = a.x;
            o[c][4 * j + 2 * h + 1] = a.y;
          }
      }

      if (hi > 0) {
        // a tile reaching past the q tile's first position is masked
        const long long first = q_off + q0;
        auto diag = [&](int kt) {
          return causal && k_off + (long long)kt * BK + BK - 1 > first;
        };
        float sc[BK / 2], corr[2];
        uint32_t pa[BK / 16][4];
        mbar_wait(q_full, qph);
        qph ^= 1;
        mbar_wait(k_full(st), ph);
        wgmma_fence();
        C::qk(sc, sQw, k_tile(st));
        wgmma_commit();
        wgmma_wait_all();
        hold(sc);
        mbar_arrive(k_empty(st));
        if (hi == 1) mbar_arrive(q_empty);  // Q's last read
        C::softmax(sc, pa, m_r, l_r, corr, scale, diag(0), q_off + r0,
                   k_off, t4);
        C::rescale(o, corr);
        int pst = st;
        uint32_t pph = ph;
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
        for (int kt = 1; kt < hi; ++kt) {
          mbar_wait(k_full(st), ph);
          mbar_wait(v_full(pst), pph);
          wgmma_fence();
          C::qk(sc, sQw, k_tile(st));
          wgmma_commit();
          C::pv(o, pa, k_tile(pst) + L::KV_BYTES);
          wgmma_commit();
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          hold(sc);  // S(kt) is done; PV(kt - 1) may still run
          mbar_arrive(k_empty(st));
          if (kt == hi - 1) mbar_arrive(q_empty);
          uint32_t pn[BK / 16][4];
          C::softmax(sc, pn, m_r, l_r, corr, scale, diag(kt), q_off + r0,
                     k_off + (long long)kt * BK, t4);
          wgmma_wait_all();
#pragma unroll
          for (int c = 0; c < NC; ++c) hold(o[c]);
          hold(pa);
          mbar_arrive(v_empty(pst));
          C::rescale(o, corr);
#pragma unroll
          for (int i = 0; i < BK / 16; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) pa[i][j] = pn[i][j];
          pst = st;
          pph = ph;
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
        mbar_wait(v_full(pst), pph);
        wgmma_fence();
        C::pv(o, pa, k_tile(pst) + L::KV_BYTES);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NC; ++c) hold(o[c]);
        hold(pa);
        mbar_arrive(v_empty(pst));
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= s) continue;
        if (t4 == 0) {
          m_out[st0 + r] = m_r[h];
          l_out[st0 + r] = l_r[h];
        }
        float* ap = acc_out + (st0 + r) * D + 2 * t4;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(ap + c * 128 + 8 * j) =
                make_float2(o[c][4 * j + 2 * h], o[c][4 * j + 2 * h + 1]);
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

// (heads, rows, d) bf16, row-major, read in boxes of `box_rows` rows x 64
// columns of one head, 128-byte swizzled; rows past the end read as zero
bool bf16_map(CUtensorMap* map, const void* ptr, int heads, int rows, int d,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)d * 2 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)PANEL, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEV = 64;

// above 48 KB of shared memory a kernel must opt in, once per device
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool (&done)[MAX_DEV], int dev) {
  if (dev < MAX_DEV && done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEV) done[dev] = true;
  return err;
}

template <int D>
int launch_hopper(const void* q, const void* k, const void* v,
                  const float* m_in, const float* l_in, const float* acc_in,
                  float* m_out, float* l_out, float* acc_out, int bh, int s,
                  int skv, int group, long long q_off, long long k_off,
                  int causal, float scale, int dev, cudaStream_t stream) {
  using L = Smem<D>;
  static bool smem_set[MAX_DEV] = {};
  static int sms[MAX_DEV] = {};
  cudaError_t err = allow_smem(flash_update_hopper<D>, L::BYTES, smem_set,
                               dev);
  if (err != cudaSuccess) return (int)err;
  int n_sm = dev < MAX_DEV ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEV) sms[dev] = n_sm;
  }
  const long long items = (long long)((s + HBQ - 1) / HBQ) * bh;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!bf16_map(&tq, q, bh, s, D, HBQ) ||
      !bf16_map(&tk, k, bh / group, skv, D, L::BK) ||
      !bf16_map(&tv, v, bh / group, skv, D, L::BK))
    return (int)cudaErrorInvalidValue;
  // persistent: at most one block per SM, each walking the work items
  const int grid = (int)(items < n_sm ? items : n_sm);
  flash_update_hopper<D><<<grid, HTHREADS, L::BYTES, stream>>>(
      tq, tk, tv, m_in, l_in, acc_in, m_out, l_out, acc_out, bh, s, skv,
      group, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}

// d >= 384: the mma.sync kernel, launched over chunks of at most 65535 q
// heads (grid y), each a multiple of the group
int launch_wide(const bf16* q, const bf16* k, const bf16* v,
                const float* m_in, const float* l_in, const float* acc_in,
                float* m_out, float* l_out, float* acc_out, int bh, int s,
                int skv, int d, int group, long long q_off, long long k_off,
                int causal, float scale, int dev, cudaStream_t stream) {
  static bool smem_set[MAX_DEV] = {};
  cudaError_t err = allow_smem(flash_update_wide, (int)SMEM, smem_set, dev);
  if (err != cudaSuccess) return (int)err;
  const int chunk = 65535 / group * group;
  for (int o = 0; o < bh; o += chunk) {
    const int n = bh - o < chunk ? bh - o : chunk;
    const long long qs = (long long)o * s, ks = (long long)(o / group) * skv;
    const dim3 grid((s + BQ - 1) / BQ, n, d / DC);
    flash_update_wide<<<grid, THREADS, SMEM, stream>>>(
        q + qs * d, k + ks * d, v + ks * d, m_in + qs, l_in + qs,
        acc_in + qs * d, m_out + qs, l_out + qs, acc_out + qs * d, s, skv, d,
        group, q_off, k_off, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// q (bh, s, d) bf16; k, v (bh / group, skv, d) bf16; m, l (bh, s) f32 and
// acc (bh, s, d) f32 in; new m, l, acc out (other buffers).  d % 128 == 0,
// skv % 128 == 0, every pointer 16-byte aligned.  d = 128 and 256 take
// the wgmma kernel, larger d the mma.sync one.  Returns cudaGetLastError().
extern "C" int dr_flash_update(const void* q, const void* k, const void* v,
                               const void* m_in, const void* l_in,
                               const void* acc_in, void* m_out, void* l_out,
                               void* acc_out, int bh, int s, int skv, int d,
                               int group, long long q_off, long long k_off,
                               int causal, void* stream) {
  if (d <= 0 || d % DC || skv <= 0 || skv % 128 || s <= 0 || bh <= 0 ||
      group <= 0 || bh % group)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)d));
  const cudaStream_t st = (cudaStream_t)stream;
  const float *mi = (const float*)m_in, *li = (const float*)l_in,
              *ai = (const float*)acc_in;
  float *mo = (float*)m_out, *lo = (float*)l_out, *ao = (float*)acc_out;
  if (d == 128)
    return launch_hopper<128>(q, k, v, mi, li, ai, mo, lo, ao, bh, s, skv,
                              group, q_off, k_off, causal, scale, dev, st);
  if (d == 256)
    return launch_hopper<256>(q, k, v, mi, li, ai, mo, lo, ao, bh, s, skv,
                              group, q_off, k_off, causal, scale, dev, st);
  return launch_wide((const bf16*)q, (const bf16*)k, (const bf16*)v, mi, li,
                     ai, mo, lo, ao, bh, s, skv, d, group, q_off, k_off,
                     causal, scale, dev, st);
}
