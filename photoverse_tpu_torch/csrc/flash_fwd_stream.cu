// Flash-attention forward for one head of 512 on Hopper's warpgroup tensor
// cores: the kernel behind `ops/flash_sdpa.py:flash_sdpa_stream` (the VAE's
// mid-block attention) and, with its log-sum-exp output, behind
// `flash_fwd_lse` at d = 512 (the forward of `flash_sdpa_stream_diff`).
//
// Replaces the TPU kernels photoverse_tpu/ops/flash_sdpa.py:_kernel_stream
// (via flash_sdpa_stream) and _kernel_stream_lse (via
// _flash_stream_fwd_lse): out = softmax(q k^T d^-0.5) v per (batch, head),
// Skv >= Sq allowed, ragged ends masked, optional lse (B, H, Sq) f32 =
// m + log(l).
//
// What bounds it on an H100: operations by the count (4 B H Sq Skv d FLOPs,
// 68.72 GFLOP and 0.0695 ms at B=2, S=4096 on 989 TFLOP/s, against 34 MB of
// q/k/v/out); a block of 64 rows reads all of K and V, 8 MB a batch
// element, so 128 blocks also pull 1 GB through the L2. What the design does
// about it:
//   - The 512-wide O is the problem: 64 rows x 512 f32 is 256 registers a
//     thread for one warpgroup. O's columns are split over two consumer
//     warpgroups, 64 x 256 each (128 registers a thread, N = 256 wgmmas).
//     Both need the whole 64 x 64 p tile, and each computes it itself: the
//     same instructions on the same shared-memory tiles give the same bits,
//     so the two halves of a row share one softmax without a word
//     exchanged, no named barrier, no p in shared memory. It costs q k^T
//     twice (1.5x the products). Each warpgroup computing only its half of
//     the keys' scores, with nothing exchanged at all (wrong, but what an
//     exchange through shared memory could gain at most), ran 14% faster:
//     too little to pay for two named barriers and 8 KB of p a tile.
//   - Both products are wgmma (bf16 operands, f32 accumulators): s = q k^T
//     from Q and K in shared memory, 32 k16 steps over eight 64-column
//     boxes; O += p v with p from registers and V's box columns
//     256 wg .. 256 wg + 255 as MN-major B (the transpose bit).
//   - The softmax stays in registers as in flash_fwd_wgmma.cu: a row lives
//     in the four lanes of a quad (two shuffles for max and sum),
//     ex2.approx with log2(e) folded into the scale, O rescaled only when a
//     row's running max moved.
//   - Shared memory: a row of 512 bf16 is eight 128-byte boxes in the
//     128-byte swizzle; Q (64 rows) is 64 KB, a tile of 64 keys 64 KB. One
//     K buffer and one V buffer (192 KB in all, one block an SM), each with
//     a full and an empty mbarrier: K of tile t + 1 arrives while p v of
//     tile t runs, V of tile t while q k^T of tile t runs, so a copy is
//     always in flight. B=2, S=4096 gives 128 blocks for 132 SMs: one wave.
//   - p is rounded to one bf16 for p v; the row sum adds the unrounded f32
//     p. The pair hi + lo (two wgmmas) was measured too: 39% slower for
//     errors that are already 0.2-0.3 of the limit (PERF.md).

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_gen.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 512;
constexpr int NWG = 2;                    // consumer warpgroups, D / NWG columns of O each
constexpr int NO = D / NWG;
constexpr int BQ = 64, BK = 64;
constexpr int NT = 128 * (NWG + 1);       // + the producer's warpgroup
constexpr int NSLAB = D / 64;             // 64-column boxes per row
constexpr int SLAB_BYTES = 64 * 128;      // one box of 64 rows
constexpr int TILE_BYTES = NSLAB * SLAB_BYTES;  // 64 rows of Q, K or V
constexpr int SMEM = 1024 + 3 * TILE_BYTES + 8 * 5;
constexpr int R0 = 65536 / NT / 8 * 8;    // 168 registers a thread at launch
constexpr int RPROD = 40;
constexpr int RCONS = (R0 * NT - 128 * RPROD) / (128 * NWG) / 8 * 8;  // 232

__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                          int h, int row, int b) {
  pv::mbar_expect_tx(bar, TILE_BYTES);
  for (int sl = 0; sl < NSLAB; ++sl)
    pv::tma_load_4d(dst + sl * SLAB_BYTES, map, bar, sl * 64, h, row, b);
}

__global__ void __launch_bounds__(NT, 1)
    flash_fwd_stream_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out,
                            float* __restrict__ lse, int H, int Sq, int Skv, float scale_log2e) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (pv::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + TILE_BYTES;
  unsigned char* Vs = Ks + TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + TILE_BYTES);
  uint64_t *q_full = bars, *k_full = bars + 1, *k_empty = bars + 2, *v_full = bars + 3,
           *v_empty = bars + 4;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (Skv + BK - 1) / BK;

  if (tid == 0) {
    pv::mbar_init(q_full, 1);
    pv::mbar_init(k_full, 1);
    pv::mbar_init(v_full, 1);
    pv::mbar_init(k_empty, 4 * NWG);  // one arrival per consumer warp
    pv::mbar_init(v_empty, 4 * NWG);
    pv::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread starts every copy ----
    pv::reg_dec<RPROD>();
    if (tid == 0) {
      load_tile(Qs, &mq, q_full, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        pv::mbar_wait(k_empty, (t & 1) ^ 1);  // passes at once the first time
        load_tile(Ks, &mk, k_full, h, t * BK, b);
        pv::mbar_wait(v_empty, (t & 1) ^ 1);
        load_tile(Vs, &mv, v_full, h, t * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroups: all 64 rows, 256 columns of O each ----
    pv::reg_inc<RCONS>();
    const int wg = tid / 128 - 1;
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int g = lane / 4, tq = lane % 4;

    float o[NO / 2];
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in log2 units
    float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

    const uint32_t q_addr = pv::smem_u32(Qs), k_addr = pv::smem_u32(Ks);
    const uint32_t v_addr = pv::smem_u32(Vs) + wg * (NO / 64) * SLAB_BYTES;
    pv::mbar_wait(q_full, 0);

    for (int t = 0; t < ntiles; ++t) {
      float sc[BK / 2];
      pv::mbar_wait(k_full, t & 1);
      pv::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        // k16 step ks: box ks / 4, then 32 bytes a step inside it
        const uint32_t off = (ks / 4) * SLAB_BYTES + (ks % 4) * 32;
        pv::wgmma_ss<BK>(sc, pv::desc_kmajor(q_addr + off), pv::desc_kmajor(k_addr + off), ks > 0);
      }
      pv::wgmma_commit();
      pv::wgmma_wait<0>();
      pv::fence_regs(sc);
      if (lane == 0) pv::mbar_arrive(k_empty);  // K is free for the next tile

      const int k0 = t * BK;
      if (k0 + BK > Skv) {  // the ragged last tile: keys past Skv count for nothing
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (k0 + 8 * (i / 4) + 2 * tq + (i & 1) >= Skv) sc[i] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // finite: every tile holds at least one key below Skv
        const float m_new = fmaxf(m_run[r], mx[r] * scale_log2e);
        alpha[r] = pv::fast_exp2(m_run[r] - m_new);
        m_run[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = pv::fast_exp2(fmaf(sc[i], scale_log2e, -m_run[r]));
        rs[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
      // the running max settles after a few tiles: rescale O only when a
      // row of this warp moved it
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < NO / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }

      // O += P V, P as the A operand from registers: accumulator columns
      // 16 kk .. 16 kk + 15 are exactly the A fragment of k16 step kk
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[kk][j] = pv::pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      pv::fence_regs(p);
      pv::mbar_wait(v_full, t & 1);
      pv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pv::wgmma_rs<NO>(o, p[kk], pv::desc_mnmajor(v_addr + kk * 2048, SLAB_BYTES), 1);
      pv::wgmma_commit();
      pv::wgmma_wait<0>();
      pv::fence_regs(o);
      if (lane == 0) pv::mbar_arrive(v_empty);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv[r] = 1.f / l_run[r];
      const int row = q0 + warp * 16 + g + 8 * r;
      if (lse != nullptr && wg == 0 && tq == 0 && row < Sq)
        lse[(static_cast<long long>(b) * H + h) * Sq + row] =
            m_run[r] * 0.69314718055994531f + logf(l_run[r]);
    }
#pragma unroll
    for (int j = 0; j < NO / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + 8 * r;
        if (row < Sq) {
          bf16* dst = out + ((static_cast<long long>(b) * Sq + row) * H + h) * D + wg * NO + 8 * j +
                      2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        }
      }
  }
}

}  // namespace

// q (B, Sq, H, 512), k/v (B, Skv, H, 512) bf16 with unit stride on the head
// dim, the other strides (b, s, h order, in elements) multiples of 8 and the
// data 16-byte aligned (TMA's rules); out a contiguous (B, Sq, H, 512) bf16
// tensor; lse null or a contiguous (B, H, Sq) f32 tensor. Returns a
// cudaError_t.
extern "C" int pv_flash_fwd_stream(const void* q, const void* k, const void* v, void* out, void* lse,
                                   int B, int Sq, int Skv, int H, int d, long long q_sb,
                                   long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                   void* stream) {
  if (Sq <= 0 || Skv <= 0 || B <= 0 || H <= 0 || d != D) return cudaErrorInvalidValue;
  cudaError_t err = pv::allow_smem(flash_fwd_stream_kernel, SMEM);
  if (err != cudaSuccess) return err;
  const long long qd[4] = {D, H, Sq, B}, kd[4] = {D, H, Skv, B};
  const long long q_st[3] = {q_sh, q_ss, q_sb}, k_st[3] = {k_sh, k_ss, k_sb}, v_st[3] = {v_sh, v_ss, v_sb};
  const int box[4] = {64, 1, 64, 1};
  CUtensorMap mq, mk, mv;
  if (!pv::cached_bf16_map(&mq, q, 4, qd, q_st, box) || !pv::cached_bf16_map(&mk, k, 4, kd, k_st, box) ||
      !pv::cached_bf16_map(&mv, v, 4, kd, v_st, box))
    return cudaErrorInvalidValue;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_stream_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(lse), H, Sq, Skv,
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}
