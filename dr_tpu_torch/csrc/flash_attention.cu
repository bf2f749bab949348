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
// Design.  On the TPU the grid runs in order on one core and VMEM holds
// megabytes, so the resident kernel keeps the whole K/V block and a 2048-row
// q tile.  Here blocks run in parallel on 132 SMs with at most 227 KB of
// shared memory each, so one kernel streams K/V through shared memory and is
// the counterpart of both:
//   * one block per (64-row q tile, q head, 128-column chunk of d), 4 warps
//     of 16 q rows, at most 168 registers a thread so that 3 blocks share
//     an SM; the q tiles are issued last-first, so under the causal mask
//     the blocks with the most K tiles start first;
//   * the block loops over 64-key K/V tiles: K row-major and V transposed in
//     shared memory (rows padded by 8 bf16, so the fragment loads hit 32
//     distinct banks).  Q and K pass through shared memory 128 columns of d
//     at a time, so a block takes 53 KB whatever d is; at d = 128 the Q tile
//     is loaded once, at larger d each chunk of it again for every K tile;
//   * QK^T and PV run on the tensor cores with mma.sync m16n8k16 bf16 -> f32.
//     The S accumulator's fragment layout is the A-operand layout of the PV
//     product, so p goes from registers to the second mma without shared
//     memory, rounded to bf16 on the way (l sums the f32 p);
//   * the online softmax stays in f32 registers: row max and row sum across
//     the 4 threads of a quad with shuffles, expf (not __expf);
//   * causal: K tiles whose first position is past the q tile's last global
//     position are skipped; the rest are masked element by element;
//   * grouped-query: q head bh reads K/V head bh / group;
//   * m/l/acc are read at the start and written at the end; d > 128 runs one
//     block per 128-column chunk of acc, each recomputing the logits, and
//     the chunk-0 block writes m and l.
//
// Bound on the H100: 2 * BH * s * skv * d operations for the ideal causal
// triangle (twice that non-causal) at 989 TFLOP/s dense bf16, against
// reading q, k, v and the state once and writing the state once at 3.35 TB/s:
// operations-bound at long context.  This first version leaves the tensor
// cores idle while tiles load (no cp.async/TMA double buffering), reads the
// Q fragments from shared memory every tile and uses mma.sync rather than
// wgmma, which alone reaches the full rate; those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

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
flash_update_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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

}  // namespace

// q (bh, s, d) bf16; k, v (bh / group, skv, d) bf16; m, l (bh, s) f32 and
// acc (bh, s, d) f32 in; new m, l, acc out (other buffers).  d % 128 == 0,
// skv % 64 == 0, bh <= 65535, every pointer 16-byte aligned.  Returns
// cudaGetLastError().
extern "C" int dr_flash_update(const void* q, const void* k, const void* v,
                               const void* m_in, const void* l_in,
                               const void* acc_in, void* m_out, void* l_out,
                               void* acc_out, int bh, int s, int skv, int d,
                               int group, long long q_off, long long k_off,
                               int causal, void* stream) {
  if (d <= 0 || d % DC || skv % BK || s <= 0 || bh <= 0 || bh > 65535 ||
      group <= 0 || bh % group)
    return (int)cudaErrorInvalidValue;
  // above 48 KB the kernel must opt in, once per device
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_update_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = true;
  }
  const float scale = (float)(1.0 / sqrt((double)d));
  const dim3 grid((s + BQ - 1) / BQ, bh, d / DC);
  flash_update_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)m_in,
      (const float*)l_in, (const float*)acc_in, (float*)m_out, (float*)l_out,
      (float*)acc_out, s, skv, d, group, q_off, k_off, causal, scale);
  return (int)cudaGetLastError();
}
