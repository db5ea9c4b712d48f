// Fused transformer-block tail for Hopper: LN2 -> dual-context
// cross-attention (text + identity, eval fusion = sum) -> to_out + bias +
// residual -> LN3 -> GEGLU feed-forward -> ff_out + bias + residual, per
// token, in one kernel.
//
// Replaces the TPU kernel photoverse_tpu/ops/fused_block.py:_kernel (via
// fused_cross_ff), at the one width the model runs it at: C = 320, 8 heads
// of 40, up to 80 text and 8 identity tokens, F a multiple of 64.
//
// What bounds it on an H100 at the main path's shape (B=2, S=4096, St=77,
// K=1, F=1280): operations. 2*B*S*C*(2C + 3F) + 4*B*S*C*(St + K) = 24.31
// GFLOP (0.0246 ms at 989 TFLOP/s) against 8 MB of activations and weights
// (0.003 ms). The Pallas kernel keeps the 2.9 MB of weights in VMEM; a
// Hopper block has 227 KB of shared memory, so the weights stream from L2.
// What the design does about it:
//   - A block owns 64 tokens (128 blocks at B=2, S=4096: one wave of the
//     132 SMs) and runs two consumer warpgroups and a producer warpgroup.
//     Every product whose B operand is a weight is wgmma (m64nNk16, bf16,
//     f32 accumulators) with the N dimension split between the two
//     warpgroups: one q projection and one to_out over all heads
//     ((64 x 320)(320 x 320), N = 2 x 80 per half), the GEGLU's a and g
//     (one warpgroup each, 64 columns of F a chunk) and ff_out.
//   - One schedule of weight tiles for the whole kernel. The weights are
//     staged (out, in) as nn.Linear holds them, which is wgmma's K-major
//     B; the producer walks one list of TMA boxes ([160 or 2 x 64 rows] x
//     64 k, 128-byte swizzle: wq, wout, then per chunk wpa + wpg and wo)
//     through a ring of four 20 KB stages with full/empty mbarriers, so
//     copies stay in flight across the products and nothing drains between
//     them.
//   - Accumulators stay in registers across a whole product. The f32
//     residual stream never touches shared memory: to_out's accumulator
//     (80 registers a thread) takes h and the bias, LN3 reads its
//     statistics from those registers (quad shuffles and one exchange
//     between the warpgroups), and ff_out's twenty chunks accumulate on
//     top of it; it is rounded to bf16 once, at the end.
//   - Operand precision. Weights are bf16 (exact). Each activation operand
//     (LN2 output, q, the softmax weights, the head outputs, LN3 output,
//     a * gelu(g)) is the bf16 pair hi + lo with hi = bf16(x), lo = bf16(x
//     - hi), and every product is issued twice: 16 bits of operand (the
//     earlier TF32 kernel kept 11) at the TF32 rate. hi alone (what the
//     TPU kernel does) was measured too: 20% faster at 0.85 of the error
//     limit (PERF.md). LN statistics, softmax, GELU (exact erff) and the
//     residual are f32.
//   - The attention itself (77 + K context tokens, d = 40, 0.8 of the 24.3
//     GFLOP) runs on mma.sync m16n8k16 straight from the q projection's
//     accumulator registers: warp i of a warpgroup holds rows 16 i .. 16 i
//     + 15 of two heads per half, which is the A fragment of q k^T as it
//     stands. K is read from a bulk copy of the context as it lies in
//     memory, V through ldmatrix.trans; the text context of four heads at a
//     time shares 50 KB, reloaded once for heads 4..7. Softmax in
//     registers; the head outputs go to shared memory as to_out's A
//     operand.
//   - Shared memory (222 KB): ring 80 KB, one hi/lo activation buffer 80 KB
//     (LN2 output, then the head outputs, then LN3 output), context 61 KB,
//     later reused for the GEGLU chunk (the a/g exchange and the hi/lo
//     product operand, 16 KB each).

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_gen.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 320, H = 8, DH = 40;
constexpr int TQ = 64;         // tokens a block
constexpr int FC = 64;         // GEGLU chunk
constexpr int NST = 4;         // ring stages
constexpr int MAX_ST = 80, MAX_K = 8;
constexpr int NT = 384;        // producer warpgroup + two consumer warpgroups
constexpr int NCONS = 256;
constexpr float LN_EPS = 1e-5f;

constexpr int SLAB = TQ * 128;           // a [64 rows][64 k] bf16 tile
constexpr int STAGE = 160 * 128;         // the largest weight tile
constexpr int OFF_A = NST * STAGE;       // hi plane (5 slabs), then lo plane
constexpr int A_PLANE = 5 * SLAB;
constexpr int OFF_CTX = OFF_A + 2 * A_PLANE;
constexpr int CTX_BYTES = 4 * MAX_ST * DH * 2;  // four heads' text K (or V)
constexpr int OFF_KT = OFF_CTX;
constexpr int OFF_VT = OFF_KT + CTX_BYTES;
constexpr int VT_PAD = 256;              // zeros read past the last head's V
constexpr int OFF_IDK = OFF_VT + CTX_BYTES + VT_PAD;
constexpr int ID_BYTES = H * 8 * DH * 2;  // [head][8 rows][40]
constexpr int OFF_IDV = OFF_IDK + ID_BYTES;
constexpr int OFF_STAT = OFF_IDV + ID_BYTES;  // [2 passes][2 warpgroups][64 rows] f32
constexpr int OFF_BAR = OFF_STAT + 2 * 2 * TQ * 4;
constexpr int NBAR = 2 * NST + 2;
constexpr int SMEM = 1024 + OFF_BAR + 8 * NBAR;
// the GEGLU chunk reuses the context's space
constexpr int OFF_ACT = OFF_CTX;              // hi [64][64], then lo
constexpr int OFF_EXCH = OFF_ACT + 2 * SLAB;  // [32][128] f32
static_assert(OFF_EXCH + 32 * 128 * 4 <= OFF_IDK, "the GEGLU chunk fits the context's space");
static_assert(SMEM <= 232448, "Hopper's shared memory per block");
static_assert(OFF_A % 1024 == 0 && OFF_CTX % 1024 == 0 && STAGE % 1024 == 0, "swizzle alignment");

struct Args {
  const bf16 *h, *kT, *vT, *kI, *vI;
  const float *ln2g, *ln2b, *bout, *ln3g, *ln3b, *bpa, *bpg, *bo;
  bf16* out;
  int S, St, K, F;
};

struct Maps {
  CUtensorMap wq, wout, wpa, wpg, wo;
};

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The pair (x0, x1) at columns (c, c + 1) of row r into the hi and lo
// planes of a swizzled activation buffer whose slabs hold 64 columns each.
__device__ __forceinline__ void store_act(unsigned char* hi_plane, int plane_bytes, int r, int c,
                                          float x0, float x1) {
  unsigned char* p = hi_plane + (c >> 6) * SLAB + pv::swz128(r, c & 63);
  uint32_t hi, lo;
  pv::split_bf16(x0, x1, hi, lo);
  *reinterpret_cast<uint32_t*>(p) = hi;
  *reinterpret_cast<uint32_t*>(p + plane_bytes) = lo;
}

// acc (64 x N, this warpgroup's columns) (+)= A[:, 64 k] B^T for one ring
// stage: A a [64][64] slab (hi at a_addr, lo plane_bytes later), B the
// stage's rows from b_addr on.
template <int N>
__device__ __forceinline__ void slab_product(float (&acc)[N / 2], uint32_t a_addr, int plane_bytes,
                                             uint32_t b_addr, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bd = pv::desc_kmajor(b_addr + 32 * kk);
    pv::wgmma_ss<N>(acc, pv::desc_kmajor(a_addr + 32 * kk), bd, !(first && kk == 0));
    pv::wgmma_ss<N>(acc, pv::desc_kmajor(a_addr + plane_bytes + 32 * kk), bd, 1);
  }
}

__global__ void __launch_bounds__(NT, 1)
    fused_cross_ff_kernel(const __grid_constant__ Maps maps, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (pv::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* full = bars;
  uint64_t* empty = bars + NST;
  uint64_t* ctx_full = bars + 2 * NST;
  uint64_t* ctx_empty = ctx_full + 1;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TQ;
  const int St = a.St, K = a.K;
  const int nchunks = a.F / FC;

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      pv::mbar_init(full + s, 1);
      pv::mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    pv::mbar_init(ctx_full, 1);
    pv::mbar_init(ctx_empty, 8);
    pv::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ================= producer warpgroup =================
    pv::reg_dec<40>();
    if (tid == 0) {
      // the weight tiles, in the order the consumers take them
      int it = 0;
      auto next_stage = [&](int bytes) -> int {
        const int s = it % NST;
        pv::mbar_wait(empty + s, ((it / NST) & 1) ^ 1);  // passes at once the first time round
        pv::mbar_expect_tx(full + s, bytes);
        ++it;
        return s;
      };
      for (int w = 0; w < 2; ++w)  // wq, then wout: two halves of N, five k slabs each
        for (int half = 0; half < 2; ++half)
          for (int ks = 0; ks < 5; ++ks) {
            const int s = next_stage(STAGE);
            pv::tma_load_2d(smem + s * STAGE, w == 0 ? &maps.wq : &maps.wout, full + s, ks * 64,
                            half * 160);
          }
      for (int c = 0; c < nchunks; ++c) {
        for (int ks = 0; ks < 5; ++ks) {  // wpa and wpg rows of this chunk
          const int s = next_stage(2 * SLAB);
          pv::tma_load_2d(smem + s * STAGE, &maps.wpa, full + s, ks * 64, c * FC);
          pv::tma_load_2d(smem + s * STAGE + SLAB, &maps.wpg, full + s, ks * 64, c * FC);
        }
        for (int half = 0; half < 2; ++half) {  // wo[:, chunk]
          const int s = next_stage(STAGE);
          pv::tma_load_2d(smem + s * STAGE, &maps.wo, full + s, c * FC, half * 160);
        }
      }
    } else if (tid == 32) {
      // the text context, four heads at a time
      const int bytes = 4 * St * DH * 2;
      for (int half = 0; half < 2; ++half) {
        if (half == 1) pv::mbar_wait(ctx_empty, 0);
        pv::mbar_expect_tx(ctx_full, 2 * bytes);
        const long long off = (static_cast<long long>(b) * H + 4 * half) * St * DH;
        pv::bulk_load(smem + OFF_KT, a.kT + off, bytes, ctx_full);
        pv::bulk_load(smem + OFF_VT, a.vT + off, bytes, ctx_full);
      }
    }
  } else {
    // ================= consumer warpgroups =================
    pv::reg_inc<232>();
    const int ct = tid - 128;              // 0..255
    const int cw = ct / 128;               // which half of every product's N
    const int t128 = ct % 128;
    const int lane = ct % 32, warp = t128 / 32;
    const int g = lane / 4, tq = lane % 4;
    const int row_lo = 16 * warp + g;      // this thread's accumulator rows: row_lo, row_lo + 8
    const uint32_t sbase = pv::smem_u32(smem);
    unsigned char* Ahi = smem + OFF_A;

    int it = 0;  // ring position, in step with the producer
    auto wait_tile = [&]() -> uint32_t {
      const int s = it % NST;
      pv::mbar_wait(full + s, (it / NST) & 1);
      return sbase + s * STAGE;
    };
    auto release_tile = [&]() {
      if (lane == 0) pv::mbar_arrive(empty + (it % NST));
      ++it;
    };

    // ---- set-up: zeros past the text V, the identity context ----
    for (int i = 4 * St * DH * 2 / 4 + ct; i < (CTX_BYTES + VT_PAD) / 4; i += NCONS)
      reinterpret_cast<uint32_t*>(smem + OFF_VT)[i] = 0u;
    for (int i = ct; i < H * 8 * DH; i += NCONS) {
      const int hd = i / (8 * DH), r = i / DH % 8, c = i % DH;
      const long long src = ((static_cast<long long>(b) * H + hd) * K + r) * DH + c;
      const bf16 zero = __float2bfloat16(0.f);
      reinterpret_cast<bf16*>(smem + OFF_IDK)[i] = r < K ? a.kI[src] : zero;
      reinterpret_cast<bf16*>(smem + OFF_IDV)[i] = r < K ? a.vI[src] : zero;
    }

    // ---- LN2 of the 64 tokens into the activation buffer (a warp a row) ----
    for (int r = ct / 32; r < TQ; r += NCONS / 32) {
      float x[10];
      const bool live = r0 + r < a.S;
      const bf16* src = a.h + (static_cast<long long>(b) * a.S + r0 + r) * C;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const __nv_bfloat162 v = live ? *reinterpret_cast<const __nv_bfloat162*>(src + 64 * i + 2 * lane)
                                      : __floats2bfloat162_rn(0.f, 0.f);
        x[2 * i] = __low2float(v);
        x[2 * i + 1] = __high2float(v);
        sum += x[2 * i] + x[2 * i + 1];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mu = sum / C;
      float var = 0.f;
#pragma unroll
      for (int i = 0; i < 10; ++i) var += (x[i] - mu) * (x[i] - mu);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
      const float inv = rsqrtf(var / C + LN_EPS);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int c = 64 * i + 2 * lane;
        store_act(Ahi, A_PLANE, r, c, (x[2 * i] - mu) * inv * a.ln2g[c] + a.ln2b[c],
                         (x[2 * i + 1] - mu) * inv * a.ln2g[c + 1] + a.ln2b[c + 1]);
      }
    }
    pv::fence_proxy_async();
    pv::named_barrier(1, NCONS);

    // ---- q = LN2(h) wq^T: per half, this warpgroup's 80 columns = two heads ----
    float qa[2][40];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      for (int ks = 0; ks < 5; ++ks) {
        const uint32_t st = wait_tile();
        pv::wgmma_fence();
        slab_product<80>(qa[half], sbase + OFF_A + ks * SLAB, A_PLANE, st + cw * 80 * 128, ks == 0);
        pv::wgmma_commit();
        pv::wgmma_wait<0>();
        release_tile();
      }
    }
    // the activation buffer is free for the head outputs once both
    // warpgroups have finished the projection
    pv::named_barrier(1, NCONS);

    // ---- dual-context attention, mma.sync, a head at a time ----
    const float qscale = 1.4426950408889634f * rsqrtf(static_cast<float>(DH));  // exp2 units
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      pv::mbar_wait(ctx_full, half);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int le = 2 * cw + e;       // head within the loaded four
        const int hd = 4 * half + le;    // head
        // A fragments of q k^T from the accumulator: k16 steps 0, 1 and the
        // half step 2 (columns 32..39, the rest zero)
        uint32_t qh[3][4], ql[3][4];
#pragma unroll
        for (int ks = 0; ks < 3; ++ks)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int tile = 2 * ks + (j >> 1);  // n8 tile of the head's 40 columns
            if (tile < 5) {
              const float x0 = qa[half][20 * e + 4 * tile + 2 * (j & 1)] * qscale;
              const float x1 = qa[half][20 * e + 4 * tile + 2 * (j & 1) + 1] * qscale;
              pv::split_bf16(x0, x1, qh[ks][j], ql[ks][j]);
            } else {
              qh[ks][j] = ql[ks][j] = 0u;
            }
          }
        // scores: ten n8 tiles of text keys, one of identity keys
        float st[10][4], si[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* Kh = reinterpret_cast<const bf16*>(smem + OFF_KT) + le * St * DH;
        const bf16* Ki = reinterpret_cast<const bf16*>(smem + OFF_IDK) + hd * 8 * DH;
#pragma unroll
        for (int n = 0; n < 10; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) st[n][i] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 3; ++ks) {
            const bf16* kp = Kh + (8 * n + g) * DH + 16 * ks + 2 * tq;
            const uint32_t b0 = pv::ld32(kp), b1 = ks < 2 ? pv::ld32(kp + 8) : 0u;
            pv::mma_bf16(st[n], qh[ks], b0, b1);
            pv::mma_bf16(st[n], ql[ks], b0, b1);
          }
        }
#pragma unroll
        for (int ks = 0; ks < 3; ++ks) {
          const bf16* kp = Ki + g * DH + 16 * ks + 2 * tq;
          const uint32_t b0 = pv::ld32(kp), b1 = ks < 2 ? pv::ld32(kp + 8) : 0u;
          pv::mma_bf16(si, qh[ks], b0, b1);
          pv::mma_bf16(si, ql[ks], b0, b1);
        }
        // two softmaxes per row (rows row_lo: i < 2, row_lo + 8: i >= 2)
        float mt[2] = {-INFINITY, -INFINITY}, mi[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 10; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (8 * n + 2 * tq + (i & 1) >= St) st[n][i] = -INFINITY;
            mt[i >> 1] = fmaxf(mt[i >> 1], st[n][i]);
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (2 * tq + (i & 1) >= K) si[i] = -INFINITY;
          mi[i >> 1] = fmaxf(mi[i >> 1], si[i]);
        }
        float lt[2] = {0.f, 0.f}, li[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = quad_max(mt[r]);
          mi[r] = quad_max(mi[r]);
        }
#pragma unroll
        for (int n = 0; n < 10; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            st[n][i] = pv::fast_exp2(st[n][i] - mt[i >> 1]);
            lt[i >> 1] += st[n][i];
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          si[i] = pv::fast_exp2(si[i] - mi[i >> 1]);
          li[i >> 1] += si[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lt[r] = 1.f / quad_sum(lt[r]);
          li[r] = 1.f / quad_sum(li[r]);
        }
        // o = softmax_t V_t + softmax_i V_i (fusion = sum)
        float o[5][4];
#pragma unroll
        for (int j = 0; j < 5; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
        const uint32_t vh = sbase + OFF_VT + le * St * DH * 2;
        const uint32_t vi = sbase + OFF_IDV + hd * 8 * DH * 2;
#pragma unroll
        for (int ks = 0; ks < 5; ++ks) {  // 16 text keys a step
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x0 = st[2 * ks + (j >> 1)][2 * (j & 1)] * lt[j & 1];
            const float x1 = st[2 * ks + (j >> 1)][2 * (j & 1) + 1] * lt[j & 1];
            pv::split_bf16(x0, x1, ph[j], pl[j]);
          }
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1, vh + ((16 * ks + (lane & 15)) * DH + 8 * j) * 2);
            pv::mma_bf16(o[j], ph, b0, b1);
            pv::mma_bf16(o[j], pl, b0, b1);
          }
        }
        {
          uint32_t ph[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 2; ++j)
            pv::split_bf16(si[2 * j] * li[j], si[2 * j + 1] * li[j], ph[j], pl[j]);
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            uint32_t b0, b1;  // both matrices read the eight identity rows; a2 = a3 = 0
            ldmatrix_x2_trans(b0, b1, vi + ((lane & 7) * DH + 8 * j) * 2);
            pv::mma_bf16(o[j], ph, b0, b1);
            pv::mma_bf16(o[j], pl, b0, b1);
          }
        }
        // the head's output as columns 40 hd .. 40 hd + 39 of to_out's A
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const int c = DH * hd + 8 * j + 2 * tq;
          store_act(Ahi, A_PLANE, row_lo, c, o[j][0], o[j][1]);
          store_act(Ahi, A_PLANE, row_lo + 8, c, o[j][2], o[j][3]);
        }
      }
      if (half == 0) {  // heads 0..3 are done with the text context
        __syncwarp();
        if (lane == 0) pv::mbar_arrive(ctx_empty);
      }
    }
    pv::fence_proxy_async();
    pv::named_barrier(1, NCONS);

    // ---- x = h + o wout^T + bout, kept in registers to the end ----
    float xa[2][40];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      for (int ks = 0; ks < 5; ++ks) {
        const uint32_t st = wait_tile();
        pv::wgmma_fence();
        slab_product<80>(xa[half], sbase + OFF_A + ks * SLAB, A_PLANE, st + cw * 80 * 128, ks == 0);
        pv::wgmma_commit();
        pv::wgmma_wait<0>();
        release_tile();
      }
    }
    // column of xa[half][4 j + i]: 160 half + 80 cw + 8 j + 2 tq + (i & 1); row: row_lo + 8 (i >> 1)
    const int col0 = 80 * cw + 2 * tq;
    float* stat = reinterpret_cast<float*>(smem + OFF_STAT);
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 10; ++j) {
        const int c = 160 * half + col0 + 8 * j;
        const float2 bias = *reinterpret_cast<const float2*>(a.bout + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + row_lo + 8 * r;
          float2 hv = make_float2(0.f, 0.f);
          if (row < a.S)
            hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                a.h + (static_cast<long long>(b) * a.S + row) * C + c));
          xa[half][4 * j + 2 * r] += hv.x + bias.x;
          xa[half][4 * j + 2 * r + 1] += hv.y + bias.y;
          rsum[r] += xa[half][4 * j + 2 * r] + xa[half][4 * j + 2 * r + 1];
        }
      }

    // ---- LN3 from the registers: mean, then variance, each exchanged
    // between the two warpgroups (each holds half of a row's columns) ----
    float mu[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] = quad_sum(rsum[r]);
      if (tq == 0) stat[cw * TQ + row_lo + 8 * r] = rsum[r];
    }
    pv::named_barrier(1, NCONS);  // also: both warpgroups are done reading the head outputs
#pragma unroll
    for (int r = 0; r < 2; ++r) mu[r] = (stat[row_lo + 8 * r] + stat[TQ + row_lo + 8 * r]) / C;
    float rvar[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 40; ++i) {
        const float t = xa[half][i] - mu[(i >> 1) & 1];
        rvar[(i >> 1) & 1] += t * t;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rvar[r] = quad_sum(rvar[r]);
      if (tq == 0) stat[2 * TQ + cw * TQ + row_lo + 8 * r] = rvar[r];
    }
    pv::named_barrier(1, NCONS);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      inv[r] = rsqrtf((stat[2 * TQ + row_lo + 8 * r] + stat[3 * TQ + row_lo + 8 * r]) / C + LN_EPS);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 10; ++j) {
        const int c = 160 * half + col0 + 8 * j;
        const float2 gw = *reinterpret_cast<const float2*>(a.ln3g + c);
        const float2 gb = *reinterpret_cast<const float2*>(a.ln3b + c);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          store_act(Ahi, A_PLANE, row_lo + 8 * r, c,
                           (xa[half][4 * j + 2 * r] - mu[r]) * inv[r] * gw.x + gb.x,
                           (xa[half][4 * j + 2 * r + 1] - mu[r]) * inv[r] * gw.y + gb.y);
      }
    pv::fence_proxy_async();
    pv::named_barrier(1, NCONS);

    // ---- GEGLU, 64 columns of F a chunk: warpgroup 0 computes a,
    // warpgroup 1 g; they swap halves so each forms a * gelu(g) for 32
    // columns; then x += (a * gelu(g)) wo[:, chunk]^T on top of xa ----
    unsigned char* act = smem + OFF_ACT;
    float* exch = reinterpret_cast<float*>(smem + OFF_EXCH);
    const float* bias_mine = cw == 0 ? a.bpa : a.bpg;
    for (int c = 0; c < nchunks; ++c) {
      float ag[32];
      for (int ks = 0; ks < 5; ++ks) {
        const uint32_t st = wait_tile();
        pv::wgmma_fence();
        slab_product<64>(ag, sbase + OFF_A + ks * SLAB, A_PLANE, st + cw * SLAB, ks == 0);
        pv::wgmma_commit();
        pv::wgmma_wait<0>();
        release_tile();
      }
      // ag[4 j + i] is column 8 j + 2 tq + (i & 1) of the chunk; add the
      // bias (and, for g, apply the GELU), then hand over the half the
      // other warpgroup finishes: a's columns 32..63, g's columns 0..31
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bias = *reinterpret_cast<const float2*>(bias_mine + c * FC + 8 * j + 2 * tq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = ag[4 * j + i] + ((i & 1) ? bias.y : bias.x);
          if (cw == 1) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
          ag[4 * j + i] = v;
        }
      }
      // (slot = register index; the same thread of the other warpgroup
      // holds the same rows and columns)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (cw == 0)
          exch[(16 + i) * 128 + t128] = ag[16 + i];
        else
          exch[i * 128 + t128] = ag[i];
      }
      pv::named_barrier(1, NCONS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int lo_half = 4 * j + 2 * r, hi_half = 16 + lo_half;  // register of columns < 32, >= 32
          float p0, p1;
          if (cw == 0) {
            p0 = ag[lo_half] * exch[lo_half * 128 + t128];
            p1 = ag[lo_half + 1] * exch[(lo_half + 1) * 128 + t128];
          } else {
            p0 = ag[hi_half] * exch[hi_half * 128 + t128];
            p1 = ag[hi_half + 1] * exch[(hi_half + 1) * 128 + t128];
          }
          store_act(act, SLAB, row_lo + 8 * r, 32 * cw + 8 * j + 2 * tq, p0, p1);
        }
      pv::fence_proxy_async();
      pv::named_barrier(1, NCONS);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t st = wait_tile();
        pv::wgmma_fence();
        slab_product<80>(xa[half], sbase + OFF_ACT, SLAB, st + cw * 80 * 128, false);
        pv::wgmma_commit();
        pv::wgmma_wait<0>();
        release_tile();
      }
    }

    // ---- out = x + bo, rounded to bf16 once ----
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 10; ++j) {
        const int c = 160 * half + col0 + 8 * j;
        const float2 bias = *reinterpret_cast<const float2*>(a.bo + c);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + row_lo + 8 * r;
          if (row < a.S)
            *reinterpret_cast<__nv_bfloat162*>(a.out + (static_cast<long long>(b) * a.S + row) * C + c) =
                __floats2bfloat162_rn(xa[half][4 * j + 2 * r] + bias.x,
                                      xa[half][4 * j + 2 * r + 1] + bias.y);
        }
      }
  }
}

}  // namespace

// h/out (B, S, 320) bf16 contiguous; kT/vT (B, 8, St, 40) and kI/vI (B, 8, K,
// 40) bf16, St <= 80, K <= 8; the weights bf16 as nn.Linear holds them, (out,
// in): wq, wout (320, 320), wpa, wpg (F, 320), wo (320, F), F a multiple of
// 64, all 16-byte aligned; the LayerNorm parameters and biases f32.
// Returns a cudaError_t.
extern "C" int pv_fused_cross_ff(const void* h, void* out, const void* kT, const void* vT,
                                 const void* kI, const void* vI, const void* ln2g,
                                 const void* ln2b, const void* wq, const void* wout,
                                 const void* bout, const void* ln3g, const void* ln3b,
                                 const void* wpa, const void* wpg, const void* bpa,
                                 const void* bpg, const void* wo, const void* bo, int B,
                                 int S, int Cin, int Hin, int St, int K, int F, void* stream) {
  if (B <= 0 || S <= 0 || Cin != C || Hin != H || St <= 0 || St > MAX_ST || K <= 0 || K > MAX_K ||
      F <= 0 || F % FC != 0)
    return cudaErrorInvalidValue;
  // (k, n) extents of the weights as nn.Linear holds them; the maps come
  // from the cache: a generation launches the same five bundles fifty times
  const long long sq[2] = {C, C}, sf[2] = {C, F}, so[2] = {F, C};
  const long long ldc[1] = {C}, ldf[1] = {F};
  const int box_sq[2] = {64, 160}, box_f[2] = {64, FC};
  Maps maps;
  if (!pv::cached_bf16_map(&maps.wq, wq, 2, sq, ldc, box_sq) ||
      !pv::cached_bf16_map(&maps.wout, wout, 2, sq, ldc, box_sq) ||
      !pv::cached_bf16_map(&maps.wpa, wpa, 2, sf, ldc, box_f) ||
      !pv::cached_bf16_map(&maps.wpg, wpg, 2, sf, ldc, box_f) ||
      !pv::cached_bf16_map(&maps.wo, wo, 2, so, ldf, box_sq))
    return cudaErrorInvalidValue;
  Args a;
  a.h = static_cast<const bf16*>(h);
  a.kT = static_cast<const bf16*>(kT);
  a.vT = static_cast<const bf16*>(vT);
  a.kI = static_cast<const bf16*>(kI);
  a.vI = static_cast<const bf16*>(vI);
  a.ln2g = static_cast<const float*>(ln2g);
  a.ln2b = static_cast<const float*>(ln2b);
  a.bout = static_cast<const float*>(bout);
  a.ln3g = static_cast<const float*>(ln3g);
  a.ln3b = static_cast<const float*>(ln3b);
  a.bpa = static_cast<const float*>(bpa);
  a.bpg = static_cast<const float*>(bpg);
  a.bo = static_cast<const float*>(bo);
  a.out = static_cast<bf16*>(out);
  a.S = S;
  a.St = St;
  a.K = K;
  a.F = F;
  cudaError_t err = pv::allow_smem(fused_cross_ff_kernel, SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((S + TQ - 1) / TQ, B);
  fused_cross_ff_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(maps, a);
  return cudaGetLastError();
}
