// Flash-attention forward on mma.sync: one templated kernel that serves
// `ops/flash_sdpa.py:flash_sdpa_stream` (the VAE's single head of 512) and,
// with its log-sum-exp output, the forward of `flash_sdpa_stream_diff`.
// Head dims 40 and 80 (`flash_sdpa`, the forward of `flash_sdpa_diff`) run
// on the wgmma kernel in flash_fwd_wgmma.cu, which took this template's
// place for them.
//
// Replaces the TPU kernels photoverse_tpu/ops/flash_sdpa.py:_kernel_stream
// (via flash_sdpa_stream, K/V streamed block by block, head dim 512) and
// its log-sum-exp variant _kernel_stream_lse (via _flash_stream_fwd_lse).
// With a non-null `lse` the kernel also writes m + log(l) per query row
// into a (B, H, Sq) f32 array, the row statistic the backward recomputes p
// from; the TPU kernels' 8- and 128-lane broadcasts of it were a tiling
// artifact and are gone. The lse variants compute in f32 on the TPU; here
// q k^T takes the bf16 inputs as they are (the products are exact, f32
// accumulation) and p v runs in TF32 (p keeps 11 significant bits), both as
// below. A block owns BQ query rows of one (b, h) and loops over K/V tiles
// it stages in shared memory, carrying the online-softmax state (m, l,
// acc) in registers. That loop takes the place of the TPU's sequential k
// grid axis and its VMEM scratch.
//
// Math (per query row): s = (q . k) * d^-0.5; m' = max(m, rowmax s);
// p = exp(s - m'); acc = acc * exp(m - m') + p v; l = l * exp(m - m') +
// rowsum p; out = acc / l. Both products run on the tensor cores with f32
// accumulation: q k^T as bf16 mma.sync (the bf16 inputs, so the products
// are exact), p v as TF32 mma.sync (p rounded to TF32, 11 significant bits;
// v converts exactly). Scores, softmax statistics and acc stay f32, and
// the output is rounded to bf16 once, so the kernel sits within about half
// a bf16 ulp of the f32 plain version (measured error in PERF.md).
//
// What bounds it on an H100 at the main path's shape: operations
// (4*B*H*S^2*d FLOPs: 68.72 GFLOP for the VAE's B=2, S=4096, H=1, d=512,
// 0.0695 ms at 989 TFLOP/s) against 34 MB of q/k/v/out, plus K/V re-reads
// per q tile that stay in the 50 MB L2. The 8 warps split each product
// into 16-row x 8-column mma tiles; the scores go through shared memory
// (f32) between the two products so that one layout serves every head
// dim, including d=512, whose 32 x 512 f32 accumulator is spread over all
// 8 warps (64 registers each). Row strides are 8 mod 16 bf16 elements, so
// the fragments load without bank conflicts. Tiles: 32 x 32 for d = 512
// (172 KB of shared memory). K and V are staged by plain loads between
// barriers and p v runs at the TF32 rate: a wgmma kernel with TMA-fed
// tiles for d = 512, as d <= 80 has, is the next step.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // 8 warps

typedef __nv_bfloat16 bf16;

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

using pv::ld32;

template <int D, int BQ, int BK>
struct Cfg {
  static constexpr int D16 = (D + 15) / 16 * 16;  // k depth of q k^T
  static constexpr int LD = D16 + 8;              // Q/K/V row stride, 8 mod 16
  static constexpr int WM = BQ / 16;              // warps along the rows
  static constexpr int WN = 8 / WM;               // warps along the columns
  static constexpr int NS = BK / 8 / WN;          // score tiles per warp
  static constexpr int NO = (D / 8 + WN - 1) / WN;  // output tiles per warp
  static constexpr int TPR = NT / BQ;             // softmax threads per row
  static constexpr int LDP = BK + TPR;            // score row stride
  static constexpr int SMEM = 2 * LD * (BQ + 2 * BK) + 4 * (BQ * LDP + 2 * BQ);
  static_assert(D % 8 == 0 && BQ % 16 == 0 && 8 % WM == 0, "tile shape");
  static_assert((BK / 8) % WN == 0 && BK % TPR == 0 && TPR <= 32, "tile shape");
};

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Skv, Strides st,
    float scale) {
  using C = Cfg<D, BQ, BK>;
  constexpr int D16 = C::D16, LD = C::LD, WM = C::WM, WN = C::WN, NS = C::NS, NO = C::NO;
  constexpr int TPR = C::TPR, LDP = C::LDP;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* Ps = reinterpret_cast<float*>(Vs + BK * LD);
  float* alpha_s = Ps + BQ * LDP;
  float* l_s = alpha_s + BQ;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = (warp % WM) * 16;  // this warp's 16 rows
  const int wn = warp / WM;         // and its column group: 8-wide tiles wn, wn + WN, ...
  const int pr = tid / TPR, pq = tid % TPR;  // softmax: row pr, columns pq + TPR * j
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;

  // rows [r0, r0 + rows) of a (S, D) head into a padded tile, as bf16 pairs;
  // zeros past `valid` rows and in the D..D16 pad
  auto stage = [&](bf16* dst, const bf16* src, long long ss, int r0, int rows, int valid) {
    for (int idx = tid; idx < rows * (D16 / 2); idx += NT) {
      const int r = idx / (D16 / 2), c = idx % (D16 / 2) * 2;
      const uint32_t x = (r0 + r < valid && c < D) ? ld32(src + (r0 + r) * ss + c) : 0u;
      *reinterpret_cast<uint32_t*>(dst + r * LD + c) = x;
    }
  };
  stage(Qs, q + b * st.q_sb + h * st.q_sh, st.q_ss, q0, BQ, Sq);
  const bf16* kb = k + b * st.k_sb + h * st.k_sh;
  const bf16* vb = v + b * st.v_sb + h * st.v_sh;

  float m_run = -INFINITY, l_run = 0.f;  // row pr's statistics
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;

  for (int k0 = 0; k0 < Skv; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P have been read
    stage(Ks, kb, st.k_ss, k0, BK, Skv);
    stage(Vs, vb, st.v_ss, k0, BK, Skv);
    __syncthreads();

    // scores: bf16 mma, scaled, -inf past Skv, into Ps
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D16; kk += 16) {
      const bf16* qa = Qs + (m0 + g) * LD + kk + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8), ld32(qa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bf16* kp = Ks + ((wn + WN * j) * 8 + g) * LD + kk + 2 * t;
        pv::mma_bf16(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = (wn + WN * j) * 8 + 2 * t + (i & 1);
        Ps[(m0 + g + 8 * (i >> 1)) * LDP + col] = k0 + col < Skv ? s[j][i] * scale : -INFINITY;
      }
    __syncthreads();

    // online softmax over the tile, TPR neighbouring lanes per row
    {
      float* prow = Ps + pr * LDP;
      float mx = -INFINITY;
#pragma unroll
      for (int j = pq; j < BK; j += TPR) mx = fmaxf(mx, prow[j]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);  // finite: every tile has a valid column
      float rs = 0.f;
#pragma unroll
      for (int j = pq; j < BK; j += TPR) {
        const float p = expf(prow[j] - m_new);
        prow[j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + rs;
      m_run = m_new;
      if (pq == 0) alpha_s[pr] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p v: TF32 mma (columns of P past Skv are 0, and
    // so are the staged V rows there)
    const float al_lo = alpha_s[m0 + g], al_hi = alpha_s[m0 + g + 8];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= al_lo;
      o[j][1] *= al_lo;
      o[j][2] *= al_hi;
      o[j][3] *= al_hi;
    }
    const int kn = min(BK, Skv - k0);
    for (int kc = 0; kc < kn; kc += 8) {
      const float* pa = Ps + (m0 + g) * LDP + kc + t;
      const uint32_t a[4] = {pv::tf32(pa[0]), pv::tf32(pa[8 * LDP]), pv::tf32(pa[4]),
                             pv::tf32(pa[8 * LDP + 4])};
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int n0 = (wn + WN * j) * 8;
        if (n0 < D) {  // uniform over the warp
          const bf16* vp = Vs + (kc + t) * LD + n0 + g;
          pv::mma_tf32(o[j], a, pv::bf16_tf32(vp[0]), pv::bf16_tf32(vp[4 * LD]));
        }
      }
    }
  }

  if (pq == 0) {
    l_s[pr] = l_run;
    if (lse != nullptr && q0 + pr < Sq)
      lse[(static_cast<long long>(b) * H + h) * Sq + q0 + pr] = m_run + logf(l_run);
  }
  __syncthreads();
  const float inv[2] = {1.f / l_s[m0 + g], 1.f / l_s[m0 + g + 8]};
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int col = (wn + WN * j) * 8 + 2 * t;
    if (col >= D) continue;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = q0 + m0 + g + 8 * hi;
      if (r >= Sq) continue;
      bf16* dst = out + ((static_cast<long long>(b) * Sq + r) * H + h) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(o[j][2 * hi] * inv[hi], o[j][2 * hi + 1] * inv[hi]);
    }
  }
}

template <int D, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Sq, int Skv, int H, const Strides& st, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D, BQ, BK>;
  constexpr int smem = Cfg<D, BQ, BK>::SMEM;
  cudaError_t err = pv::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, H, Sq, Skv, st,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                     int Sq, int Skv, int H, int D, const Strides& st, cudaStream_t s) {
  if (Sq <= 0 || Skv <= 0 || B <= 0 || H <= 0) return cudaErrorInvalidValue;
  switch (D) {
    case 512: return launch<512, 32, 32>(q, k, v, out, lse, B, Sq, Skv, H, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D), k/v (B, Skv, H, D) bf16 with unit stride on D, even
// strides and 4-byte aligned data; out is a contiguous (B, Sq, H, D) bf16
// tensor. Returns cudaGetLastError().
extern "C" int pv_flash_fwd(const void* q, const void* k, const void* v, void* out,
                            int B, int Sq, int Skv, int H, int D, long long q_sb,
                            long long q_ss, long long q_sh, long long k_sb,
                            long long k_ss, long long k_sh, long long v_sb,
                            long long v_ss, long long v_sh, void* stream) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  return dispatch(q, k, v, out, nullptr, B, Sq, Skv, H, D, st, static_cast<cudaStream_t>(stream));
}

// As pv_flash_fwd, and also writes lse, a contiguous (B, H, Sq) f32 tensor:
// the log-sum-exp of each query row's scaled scores.
extern "C" int pv_flash_fwd_lse(const void* q, const void* k, const void* v, void* out,
                                void* lse, int B, int Sq, int Skv, int H, int D,
                                long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                void* stream) {
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  return dispatch(q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, H, D, st,
                  static_cast<cudaStream_t>(stream));
}
