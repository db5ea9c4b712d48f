// The no-grad dual-context cross-attention of the UNet's unfused transformer
// blocks, per query row and head:
//
//     out = softmax(q k^T / sqrt(d)) v + softmax(q k_ip^T / sqrt(d)) v_ip
//
// over the layer's St <= 80 text and K <= 8 identity context rows, in one
// launch: the kernel behind `ops/dual_cross_attn.py:dual_cross_attention`,
// which `models/unet.py:DualCrossAttention` takes for a bf16 CUDA input
// under no_grad, in eval fusion and without an identity mask.
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA's
// einsums (photoverse_tpu/ops/attention.py:dual_context_attention), which
// XLA fuses. In eager PyTorch the same einsums launch 27 kernels a block (f32
// casts of q, k and v, permute copies for bmm, two f32 products on CUDA cores
// per context, the softmax, rounding casts, the sum) and move about 115
// bytes of device memory for every element of q.
//
// What bounds it on an H100: bytes. q is read once and the output written
// once, 4 bytes an element; the context is St + K rows a head, a few KB that
// every block of the head reads again from L2. The two products are
// 4 (St + K) d FLOPs for every d elements of q, about 80 FLOPs a byte at
// St + K = 81: under the 295 a byte where the tensor cores would bind, far
// over what f32 on CUDA cores would sustain. What the design does about it:
//   - A block takes 128 query rows of one (batch, head): grid (ceil(S / 128),
//     H, B). It copies the head's text and identity K and V into shared
//     memory (rows zero-padded to 80 and 8, the head dim to a multiple of 16)
//     and its q rows, with 16-byte cp.async reads straight from the strided
//     tensors: no permute or cast is ever written. Four warps take two
//     16-row tiles each and compute the first while the second is still
//     loading; 34-54 KB of shared memory a block (d = 40 .. 80) keep four
//     blocks, and their loads, in flight on each SM. At d = 160 the context
//     alone takes 59 KB, two blocks fit an SM, and eight warps take one tile
//     each (two tiles a warp measured slower there).
//   - Scores on the tensor cores: mma.sync m16n8k16 with bf16 q and k (exact
//     products) and f32 accumulators, ten n8 tiles of text keys and one of
//     identity keys a warp, q's A fragments through ldmatrix.
//   - Each softmax whole in f32 registers (all keys fit one tile, so nothing
//     is rescaled): row max and sum over the quad that holds a row. The
//     probabilities are rounded to bf16 as the einsum route's `.to(q.dtype)`
//     rounds them, and P v accumulates in f32 on mma.sync (V through
//     ldmatrix.trans), text and identity into one accumulator: the sum is
//     f32 and the output is rounded once, where the einsum route rounds each
//     context's output and then their sum.
//   - The output goes back through the warp's own q rows in shared memory
//     and out as 16-byte stores of whole head rows of (B, S, H, d).

#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 128;   // query rows a block
constexpr int MAX_ST = 80;  // text rows: ten n8 score tiles, five k16 steps of P v
constexpr int MAX_K = 8;    // identity rows: one n8 score tile

template <int D>
struct Cfg {
  // four warps of two 16-row tiles (the second tile's loads in flight while
  // the first is computed, four blocks an SM), or at d = 160, whose context
  // fills half an SM's shared memory, eight warps of one
  static constexpr int TILES = D == 160 ? 1 : 2;
  static constexpr int WARPS = ROWS / 16 / TILES;
  static constexpr int NT = 32 * WARPS;
  static constexpr int MIN_BLOCKS = D == 160 ? 2 : 4;
  static constexpr int DP = (D + 15) / 16 * 16;  // head dim padded to whole k16 steps
  static constexpr int LD = DP + 8;              // shared row stride: 16 bytes of skew, no bank conflicts
  static constexpr int CH = D / 8;               // 16-byte chunks of a row in device memory
  static constexpr int CHP = DP / 8;             // ... in shared memory
  // element offsets: q (then the output) ROWS rows, text K and V, identity K and V
  static constexpr int KT = ROWS * LD, VT = KT + MAX_ST * LD, KI = VT + MAX_ST * LD, VI = KI + MAX_K * LD;
  static constexpr int SMEM = (VI + MAX_K * LD) * 2;  // bytes
};

struct Args {
  const bf16 *q, *k, *v, *ki, *vi;
  bf16* out;
  int S, H, St, K;
  long long qs[3], ks[3], vs[3], kis[3], vis[3];  // strides of b, s, h in elements
  float scale;                                     // log2(e) / sqrt(d): scores in exp2 units
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, the rest of the 16 zero-filled
// past `src_bytes` (0: all zero, nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>  // all but the newest N groups of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) as one bf16 pair, lo at the lower address
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Rows [0, n) of head h of batch row b of a (B, n, H, D) tensor into `rows`
// rows of shared memory; zero past n and past D.
template <int D>
__device__ __forceinline__ void load_ctx(bf16* dst, const bf16* src, const long long (&st)[3], int b, int h, int n,
                                         int rows) {
  using C = Cfg<D>;
  const bf16* base = src + b * st[0] + h * st[2];
  for (int i = threadIdx.x; i < rows * C::CHP; i += C::NT) {
    const int r = i / C::CHP, c = i % C::CHP;
    bf16* d = dst + r * C::LD + 8 * c;
    if (r < n && c < C::CH)
      cp_async16(d, base + r * st[1] + 8 * c, 16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// One warp's 16 query rows at qw (shared memory, LD apart), the head's
// context at sm: the rows' outputs back into qw, then out to `ob`.
template <int D>
__device__ __forceinline__ void tile(const Args& a, bf16* sm, bf16* qw, bf16* ob, int rows) {
  using C = Cfg<D>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  // ---- scores: rows g and g + 8 of the warp's 16, keys 8 n + 2 t, + 1 ----
  float st[MAX_ST / 8][4], si[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int n = 0; n < MAX_ST / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) st[n][i] = 0.f;
  const bf16* kt = sm + C::KT + g * C::LD + 2 * t;
  const bf16* kid = sm + C::KI + g * C::LD + 2 * t;
  const uint32_t qa_addr = smem_addr(qw + (lane & 15) * C::LD + 8 * (lane >> 4));
#pragma unroll
  for (int ks = 0; ks < C::DP / 16; ++ks) {
    uint32_t qa[4];
    ldmatrix_x4(qa, qa_addr + 32 * ks);
#pragma unroll
    for (int n = 0; n < MAX_ST / 8; ++n) {
      const bf16* kp = kt + 8 * n * C::LD + 16 * ks;
      pv::mma_bf16(st[n], qa, pv::ld32(kp), pv::ld32(kp + 8));
    }
    pv::mma_bf16(si, qa, pv::ld32(kid + 16 * ks), pv::ld32(kid + 16 * ks + 8));
  }

  // ---- both softmaxes in f32; register i holds row g + 8 (i >> 1) ----
  float mt[2] = {-INFINITY, -INFINITY}, mi[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < MAX_ST / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st[n][i] = 8 * n + 2 * t + (i & 1) < a.St ? st[n][i] * a.scale : -INFINITY;
      mt[i >> 1] = fmaxf(mt[i >> 1], st[n][i]);
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    si[i] = 2 * t + (i & 1) < a.K ? si[i] * a.scale : -INFINITY;
    mi[i >> 1] = fmaxf(mi[i >> 1], si[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = quad_max(mt[r]);
    mi[r] = quad_max(mi[r]);
  }
  float lt[2] = {0.f, 0.f}, li[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < MAX_ST / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st[n][i] = fast_exp2(st[n][i] - mt[i >> 1]);
      lt[i >> 1] += st[n][i];
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    si[i] = fast_exp2(si[i] - mi[i >> 1]);
    li[i >> 1] += si[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lt[r] = 1.f / quad_sum(lt[r]);
    li[r] = 1.f / quad_sum(li[r]);
  }
  // the bf16 probabilities as A fragments of P v: text keys 16 ks .. 16 ks
  // + 15, the identity's eight keys with keys 8..15 zero
  uint32_t pt[MAX_ST / 16][4], pi[4];
#pragma unroll
  for (int ks = 0; ks < MAX_ST / 16; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* s = st[2 * ks + (j >> 1)];
      pt[ks][j] = pack_bf16(s[2 * (j & 1)] * lt[j & 1], s[2 * (j & 1) + 1] * lt[j & 1]);
    }
  pi[0] = pack_bf16(si[0] * li[0], si[1] * li[0]);
  pi[1] = pack_bf16(si[2] * li[1], si[3] * li[1]);
  pi[2] = pi[3] = 0u;

  // ---- out = P_t V_t + P_i V_i, eight columns at a time, into the warp's q rows ----
  const uint32_t vt = smem_addr(sm + C::VT + (lane & 15) * C::LD);
  const uint32_t vid = smem_addr(sm + C::VI + (lane & 7) * C::LD);  // both matrices: the eight identity rows
  __syncwarp();  // every lane's q fragments are read before the rows take the output
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < MAX_ST / 16; ++ks) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, vt + (16 * ks * C::LD + 8 * j) * 2);
      pv::mma_bf16(o, pt[ks], b0, b1);
    }
    uint32_t b0, b1;
    ldmatrix_x2_trans(b0, b1, vid + 8 * j * 2);
    pv::mma_bf16(o, pi, b0, b1);
    *reinterpret_cast<__nv_bfloat162*>(qw + g * C::LD + 8 * j + 2 * t) = __floats2bfloat162_rn(o[0], o[1]);
    *reinterpret_cast<__nv_bfloat162*>(qw + (g + 8) * C::LD + 8 * j + 2 * t) = __floats2bfloat162_rn(o[2], o[3]);
  }
  __syncwarp();
  for (int i = lane; i < rows * C::CH; i += 32) {
    const int r = i / C::CH, c = i % C::CH;
    *reinterpret_cast<uint4*>(ob + static_cast<long long>(r) * a.H * D + 8 * c) =
        *reinterpret_cast<const uint4*>(qw + r * C::LD + 8 * c);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT, Cfg<D>::MIN_BLOCKS) dual_cross_attn_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int TILES = C::TILES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * ROWS + warp * 16 * TILES;  // the warp's first query row

  // group 0: the context and the warp's first tile of q; group t: tile t
  load_ctx<D>(sm + C::KT, a.k, a.ks, b, h, a.St, MAX_ST);
  load_ctx<D>(sm + C::VT, a.v, a.vs, b, h, a.St, MAX_ST);
  load_ctx<D>(sm + C::KI, a.ki, a.kis, b, h, a.K, MAX_K);
  load_ctx<D>(sm + C::VI, a.vi, a.vis, b, h, a.K, MAX_K);
  bf16* qw = sm + warp * 16 * TILES * C::LD;
  const bf16* qb = a.q + b * a.qs[0] + h * a.qs[2];
#pragma unroll
  for (int tl = 0; tl < TILES; ++tl) {
    for (int i = lane; i < 16 * C::CHP; i += 32) {
      const int r = 16 * tl + i / C::CHP, c = i % C::CHP;
      bf16* d = qw + r * C::LD + 8 * c;
      if (c < C::CH) {
        const bool in = r0 + r < a.S;
        cp_async16(d, in ? qb + (r0 + r) * a.qs[1] + 8 * c : qb, in ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  }
  cp_async_wait<TILES - 1>();
  __syncthreads();
  bf16* ob = a.out + ((static_cast<long long>(b) * a.S + r0) * a.H + h) * D;
#pragma unroll
  for (int tl = 0; tl < TILES; ++tl) {
    const int first = r0 + 16 * tl;
    if (first >= a.S) return;
    if (tl > 0) {  // TILES is 2: the second tile's group
      cp_async_wait<0>();
      __syncwarp();
    }
    tile<D>(a, sm, qw + 16 * tl * C::LD, ob + static_cast<long long>(16 * tl) * a.H * D, min(16, a.S - first));
  }
}

template <int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  auto kern = dual_cross_attn_kernel<D>;
  cudaError_t err = pv::allow_smem(kern, Cfg<D>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + ROWS - 1) / ROWS, a.H, B);
  kern<<<grid, Cfg<D>::NT, Cfg<D>::SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k, v (B, St, H, D), k_ip, v_ip (B, K, H, D), bf16 with unit
// stride on D and the other strides (b, s, h order, in elements) multiples of
// 8, the data 16-byte aligned; D 40, 64, 80 or 160, 1 <= St <= 80, 1 <= K <=
// 8; out a contiguous (B, S, H, D) bf16 tensor. Returns a cudaError_t.
extern "C" int pv_dual_cross_attn(const void* q, const void* k, const void* v, const void* k_ip, const void* v_ip,
                                  void* out, int B, int S, int H, int D, int St, int K, long long q_sb,
                                  long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh, long long ki_sb, long long ki_ss,
                                  long long ki_sh, long long vi_sb, long long vi_ss, long long vi_sh, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535 || St <= 0 || St > MAX_ST || K <= 0 || K > MAX_K)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
               static_cast<const bf16*>(k_ip), static_cast<const bf16*>(v_ip), static_cast<bf16*>(out),
               S, H, St, K,
               {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {ki_sb, ki_ss, ki_sh},
               {vi_sb, vi_ss, vi_sh},
               static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 40) return launch<40>(a, B, s);
  if (D == 64) return launch<64>(a, B, s);
  if (D == 80) return launch<80>(a, B, s);
  if (D == 160) return launch<160>(a, B, s);
  return cudaErrorInvalidValue;
}
