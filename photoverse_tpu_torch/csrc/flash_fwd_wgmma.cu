// Flash-attention forward for head dims 40, 64 and 80 on Hopper's warpgroup
// tensor cores: the kernel behind `ops/flash_sdpa.py:flash_sdpa` and, with
// its log-sum-exp output, behind `flash_fwd_lse` (the forward of
// `flash_sdpa_diff`) at the UNet's head dims (SD-1.5's 40 and 80, SDXL's 64). The d = 512 paths have their
// own kernel in flash_fwd_stream.cu.
//
// Replaces the TPU kernels photoverse_tpu/ops/flash_sdpa.py:_kernel (via
// flash_sdpa) and _kernel_lse (via _flash_fwd_lse): out = softmax(q k^T
// d^-0.5) v per (batch, head), Sq != Skv allowed, ragged ends masked,
// optional lse (B, H, Sq) f32 = m + log(l).
//
// What bounds it on an H100: operations. 4*B*H*Sq*Skv*d FLOPs (42.95 GFLOP
// at B=2, S=4096, H=8, d=40: 0.0434 ms at 989 TFLOP/s) against 21 MB of
// q/k/v/out (0.006 ms at 3.35 TB/s), plus one exp per score. What the
// design does about it:
//   - Both products are wgmma (m64nNk16, bf16 operands, f32 accumulators).
//     A block owns 128 query rows of one (b, h): two consumer warpgroups
//     of 64 rows each and one producer warp. S = Q K^T takes Q
//     and K from shared memory; O += P V takes P from registers and V
//     straight from its tile (keys x d with d contiguous is wgmma's
//     MN-major B, read with the transpose bit).
//   - The head dim is not padded in device memory. Tiles are TMA boxes of
//     64 columns (128 bytes, the 128-byte swizzle, so the descriptors are
//     the plain K-major / MN-major ones and a k16 step is an address
//     offset): d = 40 is one box whose columns 40..63 TMA fills with
//     zeros, of which q k^T reads three k16 steps (48 columns); d = 64 is
//     one box read whole in four k16 steps; d = 80 is two boxes, and its
//     five k16 steps read 64 + 16 columns. P V has N = d exactly (40, 64
//     or 80).
//   - The softmax stays in registers: a wgmma accumulator holds each row
//     in the four lanes of a quad, so row max and row sum are two quad
//     shuffles; ex2.approx with log2(e) folded into the scale; m, l and
//     the rescale of O (skipped while the running max stands) per thread.
//     No score passes through shared memory and no block-wide barrier sits
//     in the loop.
//   - K and V tiles of 64 keys arrive through a ring of NST stages (three
//     at d = 40 and d = 64, whose tiles are one box each and so the same
//     bytes, two at d = 80: what lets two blocks share an SM's shared
//     memory), each with a full
//     and an empty mbarrier; the producer runs ahead of the consumers, so
//     copies are in flight while the tensor cores work.
//   - P is rounded to bf16 for P V (what the TPU kernel's fast_scores
//     route does; the pair hi = bf16(p), lo = bf16(p - hi) with two wgmmas
//     was measured too: 38-46% slower for errors already a quarter of the
//     limit, PERF.md). The row sum l adds the unrounded f32 p. O / l is
//     rounded to bf16 once.
//   - Enough blocks: two 128-row blocks share an SM (104 registers a
//     consumer thread after setmaxnreg, 67 or 99 KB of shared memory), so
//     four consumer warpgroups interleave their softmax with each other's
//     products. B=2, S=1024, H=8 gives only 128 such blocks for 132 SMs;
//     64-row blocks (256 blocks) were measured there and are 7-10% slower,
//     and 128-key tiles with one block an SM win 7% there and lose 10% at
//     d = 40, so every shape takes this one (PERF.md).

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_gen.cuh"

namespace {

typedef __nv_bfloat16 bf16;

template <int D>
struct Cfg {
  static constexpr int NWG = 2;                    // consumer warpgroups
  static constexpr int BK = 64;                    // keys a tile
  static constexpr int NST = D == 80 ? 2 : 3;      // ring stages
  static constexpr int MINB = 2;                   // blocks an SM
  static constexpr int BQ = 64 * NWG;
  static constexpr int NT = 128 * (NWG + 1);       // + the producer's warpgroup
  static constexpr int NSLAB = (D + 63) / 64;      // 64-column boxes per row
  static constexpr int KSTEPS = (D + 15) / 16;     // k16 steps of q k^T
  static constexpr int Q_BYTES = BQ * 128 * NSLAB;
  static constexpr int T_BYTES = BK * 128 * NSLAB;  // one K or one V tile
  static constexpr int BAR_BYTES = 8 * (2 * NST + 1);
  // 1024 spare bytes: the tiles start at the next 1024-byte boundary
  static constexpr int SMEM = 1024 + Q_BYTES + NST * 2 * T_BYTES + BAR_BYTES;
  // registers: the block starts with R0 a thread (the SM's 65536 over
  // MINB blocks); the producer's warpgroup gives some up (setmaxnreg) and
  // the consumers share them out: 24 / 104
  static constexpr int R0 = 65536 / (NT * MINB) / 8 * 8;
  static constexpr int RPROD = 24;
  static constexpr int RCONS = (R0 * NT - 128 * RPROD) / (128 * NWG) / 8 * 8;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT, Cfg<D>::MINB)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out,
                           float* __restrict__ lse, int H, int Sq, int Skv, float scale_log2e) {
  using C = Cfg<D>;
  constexpr int NWG = C::NWG, BK = C::BK, NST = C::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (pv::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Ts = smem + C::Q_BYTES;  // stage s: K tile, then V tile
  uint64_t* bars = reinterpret_cast<uint64_t*>(Ts + NST * 2 * C::T_BYTES);
  uint64_t* full = bars;
  uint64_t* empty = bars + NST;
  uint64_t* q_full = bars + 2 * NST;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * C::BQ;
  const int ntiles = (Skv + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      pv::mbar_init(full + s, 1);
      pv::mbar_init(empty + s, 4 * NWG);  // one arrival per consumer warp
    }
    pv::mbar_init(q_full, 1);
    pv::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    pv::reg_dec<C::RPROD>();
    if (tid == 0) {
      pv::mbar_expect_tx(q_full, C::Q_BYTES);
      for (int sl = 0; sl < C::NSLAB; ++sl)
        pv::tma_load_4d(Qs + sl * C::BQ * 128, &mq, q_full, sl * 64, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % NST;
        pv::mbar_wait(empty + s, ((t / NST) & 1) ^ 1);  // passes at once the first time round
        pv::mbar_expect_tx(full + s, 2 * C::T_BYTES);
        unsigned char* Ks = Ts + s * 2 * C::T_BYTES;
        unsigned char* Vs = Ks + C::T_BYTES;
        for (int sl = 0; sl < C::NSLAB; ++sl) {
          pv::tma_load_4d(Ks + sl * BK * 128, &mk, full + s, sl * 64, h, t * BK, b);
          pv::tma_load_4d(Vs + sl * BK * 128, &mv, full + s, sl * 64, h, t * BK, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    pv::reg_inc<C::RCONS>();
    const int wg = tid / 128 - 1;
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int g = lane / 4, tq = lane % 4;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in log2 units
    float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

    const uint32_t q_addr = pv::smem_u32(Qs) + wg * 64 * 128;
    pv::mbar_wait(q_full, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % NST;
      const uint32_t k_addr = pv::smem_u32(Ts) + s * 2 * C::T_BYTES;
      const uint32_t v_addr = k_addr + C::T_BYTES;
      pv::mbar_wait(full + s, (t / NST) & 1);

      float sc[BK / 2];
      pv::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::KSTEPS; ++ks) {
        // k16 step ks: slab ks / 4, then 32 bytes a step inside it
        pv::wgmma_ss<BK>(sc, pv::desc_kmajor(q_addr + (ks / 4) * C::BQ * 128 + (ks % 4) * 32),
                         pv::desc_kmajor(k_addr + (ks / 4) * BK * 128 + (ks % 4) * 32), ks > 0);
      }
      pv::wgmma_commit();
      pv::wgmma_wait<0>();

      const int k0 = t * BK;
      if (k0 + BK > Skv) {  // the ragged last tile: keys past Skv count for nothing
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
          if (col >= Skv) sc[i] = -INFINITY;
        }
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
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }

      // O += P V, P as the A operand from registers: accumulator columns
      // 16 kk .. 16 kk + 15 are exactly the A fragment of k16 step kk
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[kk][j] = pv::pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      pv::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        pv::wgmma_rs<D>(o, p[kk], pv::desc_mnmajor(v_addr + kk * 2048, BK * 128), 1);
      pv::wgmma_commit();
      pv::wgmma_wait<0>();
      if (lane == 0) pv::mbar_arrive(empty + s);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      inv[r] = 1.f / l_run[r];
      const int row = q0 + wg * 64 + warp * 16 + g + 8 * r;
      if (lse != nullptr && tq == 0 && row < Sq)
        lse[(static_cast<long long>(b) * H + h) * Sq + row] =
            m_run[r] * 0.69314718055994531f + logf(l_run[r]);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + wg * 64 + warp * 16 + g + 8 * r;
        if (row < Sq) {
          bf16* dst = out + ((static_cast<long long>(b) * Sq + row) * H + h) * D + 8 * j + 2 * tq;
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        }
      }
  }
}

struct Problem {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int B, Sq, Skv, H;
  long long q_st[3], k_st[3], v_st[3];  // strides of h, s, b in elements
};

template <int D>
cudaError_t launch(const Problem& p, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kern = flash_fwd_wgmma_kernel<D>;
  cudaError_t err = pv::allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long qd[4] = {D, p.H, p.Sq, p.B}, kd[4] = {D, p.H, p.Skv, p.B};
  const int qbox[4] = {64, 1, C::BQ, 1}, kbox[4] = {64, 1, C::BK, 1};
  CUtensorMap mq, mk, mv;
  if (!pv::cached_bf16_map(&mq, p.q, 4, qd, p.q_st, qbox) ||
      !pv::cached_bf16_map(&mk, p.k, 4, kd, p.k_st, kbox) ||
      !pv::cached_bf16_map(&mv, p.v, 4, kd, p.v_st, kbox))
    return cudaErrorInvalidValue;
  dim3 grid((p.Sq + C::BQ - 1) / C::BQ, p.B * p.H);
  kern<<<grid, C::NT, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<bf16*>(p.out), p.lse, p.H, p.Sq, p.Skv,
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, H, D) bf16, D 40, 64 or 80 with unit stride, the
// other strides (h, s, b order, in elements) multiples of 8 and the data
// 16-byte aligned (TMA's rules); out a contiguous (B, Sq, H, D) bf16
// tensor; lse null or a contiguous (B, H, Sq) f32 tensor. Returns a
// cudaError_t.
extern "C" int pv_flash_fwd_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                                  int B, int Sq, int Skv, int H, int D, long long q_sb,
                                  long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                                  long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                                  void* stream) {
  if (Sq <= 0 || Skv <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  const Problem p{q,  k,   v, out, static_cast<float*>(lse), B, Sq, Skv, H, {q_sh, q_ss, q_sb},
                  {k_sh, k_ss, k_sb}, {v_sh, v_ss, v_sb}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 40) return launch<40>(p, s);
  if (D == 64) return launch<64>(p, s);
  if (D == 80) return launch<80>(p, s);
  return cudaErrorInvalidValue;
}
