// Flash-attention backward for head dims 40 and 80 on Hopper's warpgroup
// tensor cores: the backward of `ops/flash_sdpa.py:flash_sdpa_diff`.
//
// Replaces the TPU kernel photoverse_tpu/ops/flash_sdpa.py:_flash_bwd, whose
// two pallas_calls become the two kernels here. With s = q k^T d^-0.5,
// p = exp(s - lse), dp = g v^T, ds = p (dp - delta):
//   - _bwd_dq_kernel  -> flash_bwd_dq_kernel: a block owns 128 or 192 query
//     rows of one (b, h) and walks the 64-key tiles: dq = ds k d^-0.5.
//   - _bwd_dkv_kernel -> flash_bwd_dkv_kernel: a block owns 128 key rows and
//     walks the 64-query tiles: dv = p^T g, dk = ds^T q d^-0.5. The TPU
//     kernel carried dk/dv in VMEM scratch across a sequential grid axis;
//     blocks on a GPU run in no order, so each block owns its key rows and
//     walks every query tile itself.
// q k^T and g v^T are computed in both kernels, so nothing crosses blocks:
// no atomics, every sum in a fixed order, and two runs give bit-identical
// gradients. delta = rowsum(g out) is computed outside, in torch, as on the
// TPU (`_flash_bwd`'s jnp.sum); lse is the forward's per-row log-sum-exp.
// Sq == Skv (the wrapper raises otherwise).
//
// What bounds it on an H100: operations by the count (10 B H S^2 d FLOPs for
// the five products, 14 as computed here with the two that both kernels
// form, against 8 tensors of B S H d bf16: 214.7 GFLOP and 0.2171 ms at
// (4, 4096, 8, 40) on 989 TFLOP/s, 0.013 ms of bytes), but at head dims this
// small the exp comes first: one ex2 per score in each kernel on the
// special-function unit (32 scores a thread take a warp about 290 clocks
// there, two warps on a scheduler 600, measured) against 280-360 clocks of
// tensor-core time for the same 64 x 64 tile at d = 40. What the design
// does about it:
//   - All five products are wgmma (m64nNk16, bf16 operands, f32 sums). The
//     dq kernel has the forward's shape: s and dp are 64 x 64 accumulators
//     of a consumer warpgroup, p and ds are formed where they land, and ds,
//     rounded to bf16, is the register A operand of dq += ds k, which reads
//     the K tile as MN-major B (the transpose bit), N = d exactly. The dk/dv
//     kernel forms the transposed scores directly, s^T = k q^T and
//     dp^T = v g^T (A = the block's own K / V rows, B = the Q / G tile), so
//     p^T and ds^T land in the register-A layout of dv += p^T g and
//     dk += ds^T q, which read the G / Q tile as MN-major B. No score
//     touches shared memory and no block-wide barrier sits in the loop.
//   - A block's own rows (Q and G for dq, K and V for dk/dv) never change,
//     so a warpgroup reads their A fragments from the swizzled tile once and
//     the score products take A from registers: a 64 x 64 x 16 wgmma with
//     both operands in shared memory reads 4 KB for 32 clocks of tensor-core
//     time, all the shared-memory bandwidth there is. (Not for dk/dv at
//     d = 80, where the fragments do not fit beside two 64 x 80 outputs.)
//   - lse and delta belong to a query: two rows a thread in the dq kernel
//     (four registers, read once); in the dk/dv kernel they belong to the
//     accumulator's columns, so the producer warp brings each tile's 64 + 64
//     floats (lse already in log2 units) into shared memory beside the tile,
//     behind the same full barrier, read one tile ahead of their stage, and
//     a thread reads its 16 columns.
//   - Tiles come through a ring of four stages (K + V tiles for dq, Q + G
//     tiles and their statistics for dk/dv), each with a full and an empty
//     mbarrier; one producer thread keeps the TMA copies in flight while the
//     tensor cores work. Every box is 64 rows x 64 columns in the 128-byte
//     swizzle, so one tensor map a tensor serves both kernels; TMA's zero
//     fill pads d = 40 to 64 columns and the ragged last tile in shared
//     memory only, and scores past S get p = 0 (in the last tile's own copy
//     of the elementwise code: the other tiles carry no masks).
//   - A warpgroup alternates between elementwise work and one batch of
//     products (a tile's output products with the next tile's score
//     products, one wait a tile); other warpgroups fill that wait.
//     Registers decide how many there are. A dk/dv consumer holds s^T (32),
//     dp^T (32), the bf16 p^T and ds^T fragments (16 + 16), two output
//     accumulators (2 x 20 or 2 x 40) and the own-row fragments (24): 160 to
//     176, so two consumer warpgroups of 64 rows and the producer's, one
//     block an SM (384 threads at 168 registers, which setmaxnreg turns
//     into 40 for the producer and 232 for a consumer). The dq kernel at
//     d = 40 needs 124 and takes three consumer warpgroups (192 rows a
//     block, 512 threads, 152 registers a consumer): 9% faster than two. At
//     d = 80 three do not fit the shared memory beside four stages. Shared
//     memory: 99-115 KB at d = 40, 195 KB at d = 80.
//   - p and ds are rounded to one bf16 each (8 significant bits) for the
//     three products that take them, where the TPU kernel keeps f32; the dq
//     kernel never rounds p, only ds. The pair hi + lo (two wgmmas) was
//     measured for p and for ds, as were a second pair of score accumulators
//     (the next tile's scores started before this tile's elementwise work),
//     turns between the warpgroups, and A from shared memory: PERF.md.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_gen.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;

constexpr int BT = 64;             // rows of every TMA box and ring tile
constexpr int SLAB_BYTES = BT * 128;  // one box: 64 rows x 64 columns

template <int D, int NWG_>
struct Cfg {
  static constexpr int NWG = NWG_;               // consumer warpgroups
  static constexpr int NST = 4;                  // ring stages
  static constexpr int BM = 64 * NWG;            // rows a block owns
  static constexpr int NT = 128 * (NWG + 1);     // + the producer's warpgroup
  static constexpr int NSLAB = (D + 63) / 64;    // 64-column boxes per row
  static constexpr int T_BYTES = SLAB_BYTES * NSLAB;   // 64 rows of one tensor
  static constexpr int OWN_BYTES = 2 * NWG * T_BYTES;  // the block's rows of two tensors
  static constexpr int STAT_BYTES = 2 * BT * 4;  // a tile's lse and delta
  static constexpr int BAR_BYTES = 8 * (2 * NST + 1);
  // 1024 spare bytes: the tiles start at the next 1024-byte boundary
  static constexpr int SMEM = 1024 + OWN_BYTES + NST * (2 * T_BYTES + STAT_BYTES) + BAR_BYTES;
  static constexpr int R0 = 65536 / NT / 8 * 8;  // registers a thread at launch
  static constexpr int RPROD = 40;
  static constexpr int RCONS = (R0 * NT - 128 * RPROD) / (128 * NWG) / 8 * 8;
};

// Byte offset of k16 step ks over the head dim in a K-major tile: slab
// ks / 4, then 32 bytes a step.
__device__ __forceinline__ constexpr uint32_t kstep(int ks) { return (ks / 4) * SLAB_BYTES + (ks % 4) * 32; }

// A warpgroup's own 64 rows of a tensor as the A operand of the score
// products: from registers (REG: the fragments of every k16 step, read
// once from the swizzled tile; for warp w of the warpgroup rows 16 w + g
// and + 8, columns 16 ks + 2 tq and + 8) or from shared memory.
template <int D, bool REG>
struct OwnRows {
  static constexpr int KSTEPS = (D + 15) / 16;
  uint32_t a[REG ? KSTEPS : 1][4];
  uint32_t lo;  // the tile's K-major descriptor, low word
  __device__ __forceinline__ void load(const unsigned char* tile, int warp, int g, int tq) {
    lo = pv::desc_lo_kmajor(pv::smem_u32(tile));
    if constexpr (REG) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const unsigned char* slab = tile + (ks / 4) * SLAB_BYTES;
        const int r = 16 * warp + g, c = 16 * (ks % 4) + 2 * tq;
        a[ks][0] = *reinterpret_cast<const uint32_t*>(slab + pv::swz128(r, c));
        a[ks][1] = *reinterpret_cast<const uint32_t*>(slab + pv::swz128(r + 8, c));
        a[ks][2] = *reinterpret_cast<const uint32_t*>(slab + pv::swz128(r, c + 8));
        a[ks][3] = *reinterpret_cast<const uint32_t*>(slab + pv::swz128(r + 8, c + 8));
      }
    }
  }
};

// acc (64 x 64) = A (the warpgroup's own rows) . B^T (a 64-row tile), both
// K-major over the head dim.
template <int D, bool REG>
__device__ __forceinline__ void mma_abt(float (&acc)[32], const OwnRows<D, REG>& own, uint32_t b_addr) {
  const uint32_t b_lo = pv::desc_lo_kmajor(b_addr);
#pragma unroll
  for (int ks = 0; ks < OwnRows<D, REG>::KSTEPS; ++ks) {
    const uint64_t b = pv::desc_join(b_lo + (kstep(ks) >> 4));
    if constexpr (REG)
      pv::wgmma_rsk<64>(acc, own.a[ks], b, ks > 0);
    else
      pv::wgmma_ss<64>(acc, pv::desc_join(own.lo + (kstep(ks) >> 4)), b, ks > 0);
  }
}

// The A fragments of a 64 x 64 accumulator rounded to bf16: accumulator
// columns 16 kk .. 16 kk + 15 are exactly the A fragment of k16 step kk.
__device__ __forceinline__ void to_frags(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pv::pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
  pv::fence_regs(a);
}

// acc (64 x D) += A (64 x 64, register fragments) . B (a 64-row tile read
// as MN-major: rows are k, the head dim is N).
template <int D>
__device__ __forceinline__ void mma_frag_b(float (&acc)[D / 2], const uint32_t (&a)[4][4], uint32_t b_addr) {
  const uint32_t b_lo = pv::desc_lo_mnmajor(b_addr, SLAB_BYTES);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pv::wgmma_rs<D>(acc, a[kk], pv::desc_join(b_lo + kk * (2048 >> 4)), 1);
}

// This warpgroup's 64 rows of a contiguous (B, S, H, D) output from a 64 x D
// accumulator, times `mul`, rounded to bf16 once.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&o)[D / 2], float mul, int b,
                                           int h, int H, int S, int row0, int g, int tq) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < S) {
        bf16* dst = out + ((static_cast<long long>(b) * S + row) * H + h) * D + 8 * j + 2 * tq;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * mul, o[4 * j + 2 * r + 1] * mul);
      }
    }
}

template <class C>
struct Smem {
  unsigned char* own;    // tensor X rows of each warpgroup, then tensor Y's
  unsigned char* ring;   // stage s: X tile, then Y tile
  float* stats;          // stage s: 64 lse (log2 units), 64 delta
  uint64_t *full, *empty, *own_full;
  __device__ explicit Smem(unsigned char* raw) {
    own = raw + ((1024 - (pv::smem_u32(raw) & 1023)) & 1023);
    ring = own + C::OWN_BYTES;
    stats = reinterpret_cast<float*>(ring + C::NST * 2 * C::T_BYTES);
    full = reinterpret_cast<uint64_t*>(ring + C::NST * (2 * C::T_BYTES + C::STAT_BYTES));
    empty = full + C::NST;
    own_full = empty + C::NST;
  }
  __device__ void init_barriers() const {
    for (int s = 0; s < C::NST; ++s) {
      pv::mbar_init(full + s, 1);
      pv::mbar_init(empty + s, 4 * C::NWG);  // one arrival per consumer warp
    }
    pv::mbar_init(own_full, 1);
    pv::mbar_fence_init();
  }
  __device__ uint32_t tile(int t) const { return pv::smem_u32(ring) + (t % C::NST) * 2 * C::T_BYTES; }
  __device__ void wait_full(int t) const { pv::mbar_wait(full + t % C::NST, (t / C::NST) & 1); }
  __device__ void wait_empty(int t) const {  // passes at once the first time round
    pv::mbar_wait(empty + t % C::NST, ((t / C::NST) & 1) ^ 1);
  }
  __device__ void release(int t) const { pv::mbar_arrive(empty + t % C::NST); }
};

// 64 rows of one head from row `row` on, as NSLAB boxes.
template <class C>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                          int h, int row, int b) {
#pragma unroll
  for (int sl = 0; sl < C::NSLAB; ++sl)
    pv::tma_load_4d(dst + sl * SLAB_BYTES, map, bar, sl * 64, h, row, b);
}

// The block's own rows of tensors X and Y, once.
template <class C>
__device__ __forceinline__ void load_own(const Smem<C>& sm, const CUtensorMap* mx,
                                         const CUtensorMap* my, int h, int row0, int b) {
  pv::mbar_expect_tx(sm.own_full, C::OWN_BYTES);
  for (int w = 0; w < C::NWG; ++w) {
    load_tile<C>(sm.own + w * C::T_BYTES, mx, sm.own_full, h, row0 + 64 * w, b);
    load_tile<C>(sm.own + (C::NWG + w) * C::T_BYTES, my, sm.own_full, h, row0 + 64 * w, b);
  }
}

// Tile t of tensors U and V into its ring stage; the caller has waited for
// the stage to be empty.
template <class C>
__device__ __forceinline__ void load_stage(const Smem<C>& sm, const CUtensorMap* mu,
                                           const CUtensorMap* mv, int t, int h, int b) {
  uint64_t* bar = sm.full + t % C::NST;
  pv::mbar_expect_tx(bar, 2 * C::T_BYTES);
  unsigned char* dst = sm.ring + (t % C::NST) * 2 * C::T_BYTES;
  load_tile<C>(dst, mu, bar, h, t * BT, b);
  load_tile<C>(dst + C::T_BYTES, mv, bar, h, t * BT, b);
}

// A compile-time flag as a function argument.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// The consumers' loop over the tiles. `scores(sc, dp, t)` starts tile t's
// two score products, `elementwise(sc, dp, t, ragged)` turns them into the
// operand fragments (exp, ds, bf16: the special-function and f32 units),
// `outputs(t)` starts the products that take the fragments. Tile t's output
// products and tile t + 1's score products go out as one batch after tile
// t's elementwise work, so a warpgroup waits once a tile and the other
// warpgroups' elementwise work fills that wait. Only the last tile can be
// ragged, so only its copy of the elementwise code carries the masks. A
// stage is released once the output products that read it are complete.
template <class C, class Scores, class Elementwise, class Outputs>
__device__ __forceinline__ void consume(const Smem<C>& sm, int ntiles, int lane, Scores scores,
                                        Elementwise elementwise, Outputs outputs) {
  float sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  const auto tile = [&](int t, auto first_flag, auto last_flag) {
    constexpr bool first = decltype(first_flag)::value, last = decltype(last_flag)::value;
    if constexpr (!first) {
      pv::wgmma_wait<0>();  // tile t's scores, tile t - 1's outputs
      if (t > 0 && lane == 0) sm.release(t - 1);
      pv::fence_regs(sc);
      pv::fence_regs(dp);
      elementwise(sc, dp, t, last_flag);
    }
    if constexpr (!last) sm.wait_full(t + 1);
    // what defines the operands stays ahead of the fence
    pv::fence_regs(sc);
    pv::fence_regs(dp);
    pv::wgmma_fence();
    if constexpr (!first) outputs(t);
    if constexpr (!last) scores(sc, dp, t + 1);
    pv::wgmma_commit();
  };
  tile(-1, Flag<true>(), Flag<false>());  // tile 0's scores
  for (int t = 0; t < ntiles - 1; ++t) tile(t, Flag<false>(), Flag<false>());
  tile(ntiles - 1, Flag<false>(), Flag<true>());
  pv::wgmma_wait<0>();
}

template <int D, int NWG>
__global__ void __launch_bounds__(Cfg<D, NWG>::NT, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int H, int S, float scale) {
  using C = Cfg<D, NWG>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  const int tid = threadIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * C::BM;
  const int ntiles = (S + BT - 1) / BT;
  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread starts every copy ----
    pv::reg_dec<C::RPROD>();
    if (tid == 0) {
      load_own<C>(sm, &mq, &mg, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        sm.wait_empty(t);
        load_stage<C>(sm, &mk, &mv, t, h, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    pv::reg_inc<C::RCONS>();
    const int wg = tid / 128 - 1;
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int g = lane / 4, tq = lane % 4;
    const int row0 = q0 + wg * 64 + warp * 16;
    const float scale_log2e = scale * LOG2E;

    // rows g and g + 8: lse in log2 units, delta (0 past S: not stored)
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      const long long at = static_cast<long long>(blockIdx.y) * S + row;
      lse2[r] = row < S ? lse[at] * LOG2E : 0.f;
      dl[r] = row < S ? delta[at] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    uint32_t ds[4][4];

    pv::mbar_wait(sm.own_full, 0);
    OwnRows<D, true> qf, gf;
    qf.load(sm.own + wg * C::T_BYTES, warp, g, tq);
    gf.load(sm.own + (C::NWG + wg) * C::T_BYTES, warp, g, tq);

    consume<C>(
        sm, ntiles, lane,
        [&](float(&sc)[32], float(&dp)[32], int t) {
          mma_abt<D>(sc, qf, sm.tile(t));               // s = q k^T
          mma_abt<D>(dp, gf, sm.tile(t) + C::T_BYTES);  // dp = g v^T
        },
        [&](float(&sc)[32], float(&dp)[32], int t, auto ragged_flag) {
          constexpr bool ragged = decltype(ragged_flag)::value;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            sc[i] = pv::fast_exp2(fmaf(sc[i], scale_log2e, -lse2[(i >> 1) & 1]));  // p
            // keys past S count for nothing
            if (ragged && t * BT + 8 * (i / 4) + 2 * tq + (i & 1) >= S) sc[i] = 0.f;
            sc[i] *= dp[i] - dl[(i >> 1) & 1];  // ds
          }
          to_frags(sc, ds);
        },
        [&](int t) { mma_frag_b<D>(acc, ds, sm.tile(t)); });  // dq += ds k
    pv::fence_regs(acc);
    store_rows<D>(dq, acc, scale, b, h, H, S, row0, g, tq);
  }
}

template <int D, int NWG, bool REG>
__global__ void __launch_bounds__(Cfg<D, NWG>::NT, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mg,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int S, float scale) {
  using C = Cfg<D, NWG>;
  extern __shared__ unsigned char smem_raw[];
  const Smem<C> sm(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * C::BM;
  const int ntiles = (S + BT - 1) / BT;
  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: its first warp brings each tile's lse and
    // delta by plain loads, its first thread starts the copies ----
    pv::reg_dec<C::RPROD>();
    if (warp == 0) {
      if (lane == 0) load_own<C>(sm, &mk, &mv, h, k0, b);
      const float* lse_bh = lse + static_cast<long long>(blockIdx.y) * S;
      const float* dl_bh = delta + static_cast<long long>(blockIdx.y) * S;
      // columns lane and lane + 32 of a tile: lse in log2 units, delta (0
      // past S), read one tile ahead of their stage
      const auto stat = [&](const float* src, int col, float mul) { return col < S ? src[col] * mul : 0.f; };
      float l0 = stat(lse_bh, lane, LOG2E), l1 = stat(lse_bh, lane + 32, LOG2E);
      float d0 = stat(dl_bh, lane, 1.f), d1 = stat(dl_bh, lane + 32, 1.f);
      for (int t = 0; t < ntiles; ++t) {
        const int c = (t + 1) * BT + lane;
        const float nl0 = stat(lse_bh, c, LOG2E), nl1 = stat(lse_bh, c + 32, LOG2E);
        const float nd0 = stat(dl_bh, c, 1.f), nd1 = stat(dl_bh, c + 32, 1.f);
        sm.wait_empty(t);
        float* st = sm.stats + (t % C::NST) * 2 * BT;
        st[lane] = l0;
        st[lane + 32] = l1;
        st[BT + lane] = d0;
        st[BT + lane + 32] = d1;
        l0 = nl0, l1 = nl1, d0 = nd0, d1 = nd1;
        __syncwarp();  // the warp's stores come before its first thread's arrival
        if (lane == 0) load_stage<C>(sm, &mq, &mg, t, h, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 key rows each ----
    pv::reg_inc<C::RCONS>();
    const int wg = tid / 128 - 1;
    const int g = lane / 4, tq = lane % 4;
    const float scale_log2e = scale * LOG2E;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    uint32_t p[4][4], ds[4][4];

    pv::mbar_wait(sm.own_full, 0);
    OwnRows<D, REG> kf, vf;
    kf.load(sm.own + wg * C::T_BYTES, warp, g, tq);
    vf.load(sm.own + (C::NWG + wg) * C::T_BYTES, warp, g, tq);

    consume<C>(
        sm, ntiles, lane,
        [&](float(&st)[32], float(&dpt)[32], int t) {
          mma_abt<D>(st, kf, sm.tile(t));                // s^T = k q^T
          mma_abt<D>(dpt, vf, sm.tile(t) + C::T_BYTES);  // dp^T = v g^T
        },
        [&](float(&st)[32], float(&dpt)[32], int t, auto ragged_flag) {
          constexpr bool ragged = decltype(ragged_flag)::value;
          // this thread's columns 8 j + 2 tq, + 1 of the tile: the queries
          const float2* st_lse = reinterpret_cast<const float2*>(sm.stats + (t % C::NST) * 2 * BT) + tq;
          const float2* st_dl = st_lse + BT / 2;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 l = st_lse[4 * j];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e;
              st[i] = pv::fast_exp2(fmaf(st[i], scale_log2e, -((e & 1) ? l.y : l.x)));  // p^T
              // queries past S count for nothing
              if (ragged && t * BT + 8 * j + 2 * tq + (e & 1) >= S) st[i] = 0.f;
            }
          }
          to_frags(st, p);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float2 dl = st_dl[4 * j];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));  // ds^T
          }
          to_frags(dpt, ds);
        },
        [&](int t) {
          mma_frag_b<D>(dv_acc, p, sm.tile(t) + C::T_BYTES);  // dv += p^T g
          mma_frag_b<D>(dk_acc, ds, sm.tile(t));              // dk += ds^T q
        });
    pv::fence_regs(dk_acc);
    pv::fence_regs(dv_acc);
    const int row0 = k0 + wg * 64 + warp * 16;
    store_rows<D>(dk, dk_acc, scale, b, h, H, S, row0, g, tq);
    store_rows<D>(dv, dv_acc, 1.f, b, h, H, S, row0, g, tq);
  }
}

struct Problem {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  int B, S, H;
  long long st[4][3];  // strides of h, s, b in elements, for q, k, v, g
};

template <int D, int NWG, class K, class... Out>
cudaError_t launch_one(K kern, const CUtensorMap (&m)[4], const Problem& p, cudaStream_t stream,
                       Out... out) {
  using C = Cfg<D, NWG>;
  const cudaError_t err = pv::allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((p.S + C::BM - 1) / C::BM, p.B * p.H);
  kern<<<grid, C::NT, C::SMEM, stream>>>(m[0], m[1], m[2], m[3], p.lse, p.delta, out..., p.H, p.S, scale);
  return cudaGetLastError();
}

// The two kernels' shapes for head dim D: consumer warpgroups of the dq
// kernel, and whether the dk/dv kernel's registers hold its own rows too.
template <int D, int DQ_NWG, bool DKV_REG>
cudaError_t launch(const Problem& p, cudaStream_t stream) {
  const long long dims[4] = {D, p.H, p.S, p.B};
  const int box[4] = {64, 1, BT, 1};
  const void* base[4] = {p.q, p.k, p.v, p.g};
  CUtensorMap m[4];
  for (int i = 0; i < 4; ++i)
    if (!pv::cached_bf16_map(&m[i], base[i], 4, dims, p.st[i], box)) return cudaErrorInvalidValue;
  const cudaError_t err = launch_one<D, DQ_NWG>(flash_bwd_dq_kernel<D, DQ_NWG>, m, p, stream, p.dq);
  if (err != cudaSuccess) return err;
  return launch_one<D, 2>(flash_bwd_dkv_kernel<D, 2, DKV_REG>, m, p, stream, p.dk, p.dv);
}

}  // namespace

// q, k, v, g (B, S, H, D) bf16, D 40 or 80 with unit stride, the other
// strides (b, s, h order, in elements) multiples of 8 and the data 16-byte
// aligned (TMA's rules); lse and delta contiguous (B, H, S) f32; dq, dk, dv
// contiguous (B, S, H, D) bf16 outputs. Launches the dq kernel, then the
// dk/dv kernel, on `stream`. Returns a cudaError_t.
extern "C" int pv_flash_bwd(const void* q, const void* k, const void* v, const void* g,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int B, int S, int H, int D, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh, long long g_sb,
                            long long g_ss, long long g_sh, void* stream) {
  if (S <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  const Problem p{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, H,
                  {{q_sh, q_ss, q_sb}, {k_sh, k_ss, k_sb}, {v_sh, v_ss, v_sb}, {g_sh, g_ss, g_sb}}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 40) return launch<40, 3, true>(p, s);
  if (D == 80) return launch<80, 2, false>(p, s);
  return cudaErrorInvalidValue;
}

