// Flash-attention backward for Hopper, head dims 40 and 80: the backward of
// `ops/flash_sdpa.py:flash_sdpa_diff`.
//
// Replaces the TPU kernel photoverse_tpu/ops/flash_sdpa.py:_flash_bwd, whose
// two pallas_calls become the two kernels here:
//   - _bwd_dq_kernel  -> flash_bwd_dq_kernel: one block per (b*h, 64-query
//     tile), looping over 64-key tiles: s = q k^T * scale,
//     p = exp(s - lse), dp = g v^T, ds = p * (dp - delta), dq += ds k.
//   - _bwd_dkv_kernel -> flash_bwd_dkv_kernel: one block per (b*h, 64-key
//     tile), looping over 64-query tiles: dv += p^T g, dk += ds^T q. The TPU
//     kernel carried dk/dv in VMEM scratch across a sequential q grid axis;
//     GPU blocks run in no order, so each block owns its key rows and walks
//     every query tile itself. Nothing crosses blocks: no atomics, and two
//     runs give bit-identical gradients.
// delta = rowsum(g * out) is computed outside, in torch, as on the TPU
// (`_flash_bwd`'s jnp.sum); lse is the forward's per-row log-sum-exp
// (csrc/flash_fwd.cu). Sq == Skv (the wrapper raises otherwise).
//
// Numerics: every intermediate (s, p, dp, ds and the dq/dk/dv sums) is f32.
// Products of two bf16 tensors (q k^T, g v^T) are bf16 mma.sync with f32
// accumulation, exact products; products with an f32 operand (ds k, p^T g,
// ds^T q) are TF32 mma.sync, the f32 operand rounded to 11 significant bits
// and the bf16 one widened exactly. Outputs are rounded to bf16 once.
//
// What bounds it on an H100: 14 * B*H*S^2*d FLOPs against 4 for the
// forward (q k^T and g v^T are recomputed in both kernels), 150 GFLOP at
// B=2, S=4096, H=8, d=40; bytes are q/k/v/g once per block row plus
// re-reads that stay in the 50 MB L2. Compute-bound, on mma.sync at about
// half the bf16 rate for the TF32 products. The 8 warps split each 64x64
// product into 16-row x 8-column mma tiles; s and dp are formed in
// registers in the same fragment layout, so p and ds are computed where they
// land and only p / ds go through shared memory (f32) to become the A
// operand of the second product. Head dims 40 and 80 are zero-padded to 48
// and 80 in shared memory; bf16 row strides of 8 mod 16 elements and f32
// row strides of 4 mod 32 words keep fragment loads free of bank conflicts.
// Shared memory: dq 46-62 KB, dk/dv 64-80 KB. wgmma and TMA are the next
// step.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // 8 warps
constexpr int BM = 64;   // rows a block owns: queries (dq) or keys (dk/dv)
constexpr int BN = 64;   // columns per step of the loop: keys (dq) or queries (dk/dv)

typedef __nv_bfloat16 bf16;
using pv::ld32;

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh;
};

template <int D>
struct Cfg {
  static constexpr int D16 = (D + 15) / 16 * 16;  // k depth of the bf16 products
  static constexpr int LD = D16 + 8;              // bf16 row stride, 8 mod 16
  static constexpr int WM = BM / 16;              // warps along the rows
  static constexpr int WN = 8 / WM;               // warps along the columns
  static constexpr int NS = BN / 8 / WN;          // 8-wide score tiles per warp
  static constexpr int NO = (D / 8 + WN - 1) / WN;  // 8-wide output tiles per warp
  static constexpr int LDP = BN + 4;              // f32 row stride, 4 mod 32
  static constexpr int TILE = BM * LD;            // bf16 elements per staged tile (BM == BN)
  static constexpr int SMEM_DQ = 2 * 4 * TILE + 4 * BM * LDP;
  static constexpr int SMEM_DKV = 2 * 4 * TILE + 4 * (2 * BM * LDP + 2 * BN);
  static_assert(D % 8 == 0 && BM == BN && BM % 16 == 0 && (BN / 8) % WN == 0, "tile shape");
};

// Rows [r0, r0 + BM) of one (S, D) head into a padded tile as bf16 pairs;
// zeros past row `valid` and in the D..D16 pad.
template <int D>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, long long ss, int r0, int valid,
                                      int tid) {
  constexpr int D16 = Cfg<D>::D16, LD = Cfg<D>::LD;
  for (int idx = tid; idx < BM * (D16 / 2); idx += NT) {
    const int r = idx / (D16 / 2), c = idx % (D16 / 2) * 2;
    const uint32_t x = (r0 + r < valid && c < D) ? ld32(src + (r0 + r) * ss + c) : 0u;
    *reinterpret_cast<uint32_t*>(dst + r * LD + c) = x;
  }
}

// c[j] = A[m0:m0+16] . B[cols of tile wn + WN*j]^T over the padded depth:
// bf16 mma.sync, f32 accumulation. Fragment element i of tile j sits at
// row m0 + g + 8 * (i >> 1), column (wn + WN * j) * 8 + 2 * t + (i & 1).
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[Cfg<D>::NS][4], const bf16* A, const bf16* Bt,
                                        int m0, int wn, int g, int t) {
  using C = Cfg<D>;
#pragma unroll
  for (int j = 0; j < C::NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::D16; kk += 16) {
    const bf16* ap = A + (m0 + g) * C::LD + kk + 2 * t;
    const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * C::LD), ld32(ap + 8), ld32(ap + 8 * C::LD + 8)};
#pragma unroll
    for (int j = 0; j < C::NS; ++j) {
      const bf16* bp = Bt + ((wn + C::WN * j) * 8 + g) * C::LD + kk + 2 * t;
      pv::mma_bf16(c[j], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// o[m0:m0+16, tiles wn + WN*j] += P[m0:m0+16, :BN] . V[:BN, :D]: TF32
// mma.sync, P (f32, row stride LDP) rounded, V (bf16) widened exactly.
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[Cfg<D>::NO][4], const float* P, const bf16* V,
                                       int m0, int wn, int g, int t) {
  using C = Cfg<D>;
#pragma unroll 2
  for (int kc = 0; kc < BN; kc += 8) {
    const float* pa = P + (m0 + g) * C::LDP + kc + t;
    const uint32_t a[4] = {pv::tf32(pa[0]), pv::tf32(pa[8 * C::LDP]), pv::tf32(pa[4]),
                           pv::tf32(pa[8 * C::LDP + 4])};
#pragma unroll
    for (int j = 0; j < C::NO; ++j) {
      const int n0 = (wn + C::WN * j) * 8;
      if (n0 < D) {  // uniform over the warp
        const bf16* vp = V + (kc + t) * C::LD + n0 + g;
        pv::mma_tf32(o[j], a, pv::bf16_tf32(vp[0]), pv::bf16_tf32(vp[4 * C::LD]));
      }
    }
  }
}

// Rows [r0, r0 + BM) of a contiguous (B, S, H, D) output, from fragments.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&o)[Cfg<D>::NO][4], float mul,
                                           int b, int h, int H, int S, int r0, int m0, int wn,
                                           int g, int t) {
  using C = Cfg<D>;
#pragma unroll
  for (int j = 0; j < C::NO; ++j) {
    const int col = (wn + C::WN * j) * 8 + 2 * t;
    if (col >= D) continue;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = r0 + m0 + g + 8 * hi;
      if (r >= S) continue;
      bf16* dst = out + ((static_cast<long long>(b) * S + r) * H + h) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(o[j][2 * hi] * mul, o[j][2 * hi + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ gr, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int S, Strides st, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + C::TILE;
  bf16* Ks = Gs + C::TILE;
  bf16* Vs = Ks + C::TILE;
  float* dSs = reinterpret_cast<float*>(Vs + C::TILE);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = (warp % C::WM) * 16, wn = warp / C::WM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;

  stage<D>(Qs, q + b * st.q_sb + h * st.q_sh, st.q_ss, q0, S, tid);
  stage<D>(Gs, gr + b * st.g_sb + h * st.g_sh, st.g_ss, q0, S, tid);
  const bf16* kb = k + b * st.k_sb + h * st.k_sh;
  const bf16* vb = v + b * st.v_sb + h * st.v_sh;
  // this thread's two rows' statistics (0 past S: those rows are not stored)
  const long long row0 = static_cast<long long>(blockIdx.y) * S + q0 + m0 + g;
  const bool ok_lo = q0 + m0 + g < S, ok_hi = q0 + m0 + g + 8 < S;
  const float lse_r[2] = {ok_lo ? lse[row0] : 0.f, ok_hi ? lse[row0 + 8] : 0.f};
  const float dl_r[2] = {ok_lo ? delta[row0] : 0.f, ok_hi ? delta[row0 + 8] : 0.f};

  float acc[C::NO][4];
#pragma unroll
  for (int j = 0; j < C::NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BN) {
    __syncthreads();  // the previous tile's K, V and dS have been read
    stage<D>(Ks, kb, st.k_ss, k0, S, tid);
    stage<D>(Vs, vb, st.v_ss, k0, S, tid);
    __syncthreads();
    float s[C::NS][4], dp[C::NS][4];
    mma_abt<D>(s, Qs, Ks, m0, wn, g, t);
    mma_abt<D>(dp, Gs, Vs, m0, wn, g, t);
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hi = i >> 1;
        const int col = (wn + C::WN * j) * 8 + 2 * t + (i & 1);
        const float p = k0 + col < S ? expf(s[j][i] * scale - lse_r[hi]) : 0.f;
        dSs[(m0 + g + 8 * hi) * C::LDP + col] = p * (dp[j][i] - dl_r[hi]);
      }
    __syncthreads();
    mma_pv<D>(acc, dSs, Ks, m0, wn, g, t);  // dq += ds k
  }
  store_rows<D>(dq, acc, scale, b, h, H, S, q0, m0, wn, g, t);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ gr, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int S, Strides st, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + C::TILE;
  bf16* Qs = Vs + C::TILE;
  bf16* Gs = Qs + C::TILE;
  float* Ps = reinterpret_cast<float*>(Gs + C::TILE);  // p^T (keys x queries)
  float* dSs = Ps + BM * C::LDP;                       // ds^T
  float* lse_s = dSs + BM * C::LDP;
  float* dl_s = lse_s + BN;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = (warp % C::WM) * 16, wn = warp / C::WM;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int k0 = blockIdx.x * BM;

  stage<D>(Ks, k + b * st.k_sb + h * st.k_sh, st.k_ss, k0, S, tid);
  stage<D>(Vs, v + b * st.v_sb + h * st.v_sh, st.v_ss, k0, S, tid);
  const bf16* qb = q + b * st.q_sb + h * st.q_sh;
  const bf16* gb = gr + b * st.g_sb + h * st.g_sh;
  const float* lse_bh = lse + static_cast<long long>(blockIdx.y) * S;
  const float* dl_bh = delta + static_cast<long long>(blockIdx.y) * S;

  float dk_acc[C::NO][4], dv_acc[C::NO][4];
#pragma unroll
  for (int j = 0; j < C::NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BN) {
    __syncthreads();  // the previous tile's Q, G, P and dS have been read
    stage<D>(Qs, qb, st.q_ss, q0, S, tid);
    stage<D>(Gs, gb, st.g_ss, q0, S, tid);
    if (tid < BN) {
      const bool ok = q0 + tid < S;
      lse_s[tid] = ok ? lse_bh[q0 + tid] : 0.f;
      dl_s[tid] = ok ? dl_bh[q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[C::NS][4], dp[C::NS][4];
    mma_abt<D>(s, Ks, Qs, m0, wn, g, t);  // s^T = k q^T
    mma_abt<D>(dp, Vs, Gs, m0, wn, g, t);  // dp^T = v g^T
#pragma unroll
    for (int j = 0; j < C::NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = (wn + C::WN * j) * 8 + 2 * t + (i & 1);  // the query
        const int at = (m0 + g + 8 * (i >> 1)) * C::LDP + col;
        const float p = q0 + col < S ? expf(s[j][i] * scale - lse_s[col]) : 0.f;
        Ps[at] = p;
        dSs[at] = p * (dp[j][i] - dl_s[col]);
      }
    __syncthreads();
    mma_pv<D>(dv_acc, Ps, Gs, m0, wn, g, t);   // dv += p^T g
    mma_pv<D>(dk_acc, dSs, Qs, m0, wn, g, t);  // dk += ds^T q
  }
  store_rows<D>(dk, dk_acc, scale, b, h, H, S, k0, m0, wn, g, t);
  store_rows<D>(dv, dv_acc, 1.f, b, h, H, S, k0, m0, wn, g, t);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const void* lse,
                   const void* delta, void* dq, void* dk, void* dv, int B, int S, int H,
                   const Strides& st, cudaStream_t stream) {
  using C = Cfg<D>;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((S + BM - 1) / BM, B * H);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k);
  const bf16 *vp = static_cast<const bf16*>(v), *gp = static_cast<const bf16*>(g);
  const float *lp = static_cast<const float*>(lse), *dp = static_cast<const float*>(delta);

  auto kq = flash_bwd_dq_kernel<D>;
  cudaError_t err = pv::allow_smem(kq, C::SMEM_DQ);
  if (err != cudaSuccess) return err;
  kq<<<grid, NT, C::SMEM_DQ, stream>>>(qp, kp, vp, gp, lp, dp, static_cast<bf16*>(dq), H, S, st,
                                       scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kkv = flash_bwd_dkv_kernel<D>;
  err = pv::allow_smem(kkv, C::SMEM_DKV);
  if (err != cudaSuccess) return err;
  kkv<<<grid, NT, C::SMEM_DKV, stream>>>(qp, kp, vp, gp, lp, dp, static_cast<bf16*>(dk),
                                         static_cast<bf16*>(dv), H, S, st, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, g (B, S, H, D) bf16 with unit stride on D, even strides and
// 4-byte aligned data; lse and delta contiguous (B, H, S) f32; dq, dk, dv
// contiguous (B, S, H, D) bf16 outputs. D is 40 or 80. Launches the dq
// kernel, then the dk/dv kernel, on `stream`. Returns cudaGetLastError().
extern "C" int pv_flash_bwd(const void* q, const void* k, const void* v, const void* g,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int B, int S, int H, int D, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh, long long g_sb,
                            long long g_ss, long long g_sh, void* stream) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss, g_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  switch (D) {
    case 40: return launch<40>(q, k, v, g, lse, delta, dq, dk, dv, B, S, H, st, s);
    case 80: return launch<80>(q, k, v, g, lse, delta, dq, dk, dv, B, S, H, st, s);
    default: return cudaErrorInvalidValue;
  }
}
