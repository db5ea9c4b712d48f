// Fused transformer-block tail for Hopper: LN2 -> dual-context
// cross-attention (text + identity, eval fusion = sum) -> to_out + bias +
// residual -> LN3 -> GEGLU feed-forward -> ff_out + bias + residual, per
// token, in one kernel.
//
// Replaces the TPU kernel photoverse_tpu/ops/fused_block.py:_kernel (via
// fused_cross_ff). The Pallas kernel keeps the whole weight set (about
// 2.9 MB bf16 at C=320, F=1280) in VMEM; a Hopper block has 227 KB of
// shared memory, so here one block owns TQ=32 tokens and keeps only their
// activations on chip: the f32 residual stream x (both sub-layers add
// straight into it), the LN output, the per-head q, scores and head
// output, and one GEGLU chunk. Weights stream through a small
// shared-memory stage from L2 (5 layers x 2.9 MB fit in the 50 MB L2).
// The GEGLU hidden dimension F is walked in chunks of 128:
// a = h3 Wa[:, f], g = h3 Wg[:, f], x += (a * gelu(g)) Wo[f, :], so the
// (S, F) activation never reaches device memory. Per head the q
// projection, both softmaxes (St text tokens, K identity tokens, K=1
// handled directly) and the head's share of to_out
// (sum_h o_h Wout[h] == concat_h(o_h) Wout) run in turn.
//
// Numerics: the inputs are bf16 (the wrapper takes bf16 only) and every
// intermediate stays f32 in shared memory: LN statistics and outputs, q,
// both softmaxes, the head outputs, the residual stream and the GEGLU
// halves. The products run on the tensor cores as TF32 mma.sync with f32
// accumulation: the bf16 weights convert to TF32 exactly, and the f32
// activations are rounded to TF32 (11 significant bits) as operands. The
// output is rounded to bf16 once. The TPU kernel instead rounds its MXU
// operands and its residual stream to bf16, and fast_ln takes LN
// statistics in bf16; here LN statistics stay f32 whatever the model's
// fast_norms. GELU is exact (erff). The Mosaic-only workarounds (erf
// polynomial, identity context padded to 8 with a -1e9 bias, bf16 rsqrt)
// are gone.
//
// What bounds it on an H100 at the main path's shape (B=2, S=4096, C=320,
// H=8, St=77, K=1, F=1280): 2*B*S*C*(2C + 3F) + 4*B*S*C*(St + K) = 24 GFLOP
// against 5 MB of activations in and out, so it is compute-bound, and
// every block re-reads the 2.9 MB of weights from L2 (256 blocks: 0.75 GB
// of L2 traffic). Each GEMM pass computes a 32 x 128 output tile with the
// 8 warps each owning a 16 x 32 piece (four m16n8k8 products per k step,
// skipped past the pass's last column). Weights are staged 64 x 128 at a
// time in bf16 by 16-byte cp.async into two alternating tiles, so the
// next tile loads while the current one is multiplied. Row strides are 4
// mod 8 floats (activations) and 8 mod 16 bf16 (weights), so the mma
// fragments load without bank conflicts. One block fits per SM (175 KB of
// shared memory), so latency is hidden only by the 8 warps' independent
// products; wgmma with TMA-fed weight tiles is the next step.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // 8 warps
constexpr int TQ = 32;   // tokens per block
constexpr int NC = 128;  // output columns per GEMM pass
constexpr int KC = 64;   // reduction depth per staged weight tile
constexpr int FC = 128;  // GEGLU hidden chunk
// A staged weight tile in bf16, rows padded by 8 (conflict-free B
// fragments): KC x (NC + 8) for a (K, N) matrix, NC x (KC + 8) for (N, K).
constexpr int WST = NC * (KC + 8);
constexpr float LN_EPS = 1e-5f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, int bytes) {
  // copies `bytes` (0..16) and zero-fills the rest of the 16
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of W(k0 + k, n0 + n), k < KC, n < NC, into `dst` with
// 16-byte cp.async, zeros past Kd and N. W(k, n) = W[k * ldw + n], or
// W[n * ldw + k] when NK. ldw and W's address are multiples of 8 elements.
template <bool NK>
__device__ __forceinline__ void stage_w(bf16* dst, const bf16* W, int ldw, int k0, int n0,
                                        int Kd, int N) {
  constexpr int ROWS = NK ? NC : KC, COLS = NK ? KC : NC;  // memory order
  const int row_lim = NK ? N - n0 : Kd - k0;
  const int col_lim = NK ? Kd - k0 : N - n0;
  const bf16* base = W + (NK ? static_cast<long long>(n0) * ldw + k0
                             : static_cast<long long>(k0) * ldw + n0);
  for (int idx = threadIdx.x; idx < ROWS * COLS / 8; idx += NT) {
    const int r = idx / (COLS / 8), c = idx % (COLS / 8) * 8;
    const int n = r < row_lim ? min(8, max(0, col_lim - c)) : 0;
    cp_async16(dst + r * (COLS + 8) + c, n ? base + static_cast<long long>(r) * ldw + c : W,
               2 * n);
  }
  cp_commit();
}

// Out[r][n] (+)= sum_k A[r][k] * W(k, n) for r < TQ, n < N, k < Kd.
// A and Out are f32 in shared memory; W is bf16 in global memory, staged
// through the two tiles at `wst` (the next one loading while the current
// one is multiplied). Ends with a barrier.
template <bool ACC, bool NK>
__device__ __noinline__ void gemm(const float* A, int lda, int Kd, const bf16* __restrict__ W,
                                  int ldw, int N, float* Out, int ldo, bf16* wst) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int mr = (warp % 2) * 16;  // this warp's 16 rows of the tile
  const int nw = (warp / 2) * 32;  // and its four 8-column pieces
  const int nk = (Kd + KC - 1) / KC;
  const int steps = (N + NC - 1) / NC * nk;  // (column pass, k stage) pairs
  stage_w<NK>(wst, W, ldw, 0, 0, Kd, N);
  float c[4][4] = {};
  for (int s = 0; s < steps; ++s) {
    const int n0 = s / nk * NC, k0 = s % nk * KC;
    const int kn = min(KC, Kd - k0);
    if (s + 1 < steps) {
      stage_w<NK>(wst + (s + 1) % 2 * WST, W, ldw, (s + 1) % nk * KC, (s + 1) / nk * NC, Kd, N);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // stage s has landed for every thread
    const bf16* ws = wst + s % 2 * WST;
    const float* a_lo = A + (mr + g) * lda + k0;
    const float* a_hi = a_lo + 8 * lda;
#pragma unroll
    for (int kb = 0; kb < KC; kb += 8) {
      if (kb >= kn) break;
      const int k1 = kb + t, k2 = kb + t + 4;  // staged rows past kn are zero
      const uint32_t a[4] = {
          pv::tf32(k1 < kn ? a_lo[k1] : 0.f), pv::tf32(k1 < kn ? a_hi[k1] : 0.f),
          pv::tf32(k2 < kn ? a_lo[k2] : 0.f), pv::tf32(k2 < kn ? a_hi[k2] : 0.f)};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = nw + 8 * j + g;
        if (n0 + nw + 8 * j < N) {  // uniform over the warp
          const bf16* b0 = NK ? ws + n * (KC + 8) + k1 : ws + k1 * (NC + 8) + n;
          const bf16* b1 = NK ? b0 + 4 : b0 + 4 * (NC + 8);
          pv::mma_tf32(c[j], a, pv::bf16_tf32(*b0), pv::bf16_tf32(*b1));
        }
      }
    }
    if (s % nk == nk - 1) {  // this column pass is complete
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = n0 + nw + 8 * j + 2 * t + (i & 1);
          if (n < N) {
            float* o = Out + (mr + g + 8 * (i >> 1)) * ldo + n;
            *o = ACC ? *o + c[j][i] : c[j][i];
          }
          c[j][i] = 0.f;
        }
    }
    __syncthreads();  // stage s's tile is free for stage s + 2
  }
}

// Y = LayerNorm(X) * g + b row by row (one warp per row).
__device__ void layernorm(const float* X, float* Y, int ld, int C,
                          const float* __restrict__ g, const float* __restrict__ b) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < TQ; r += NT / 32) {
    const float* x = X + r * ld;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += x[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const float mu = s / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float t = x[c] - mu;
      v += t * t;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const float inv = rsqrtf(v / C + LN_EPS);
    for (int c = lane; c < C; c += 32) Y[r * ld + c] = (x[c] - mu) * inv * g[c] + b[c];
  }
  __syncthreads();
}

// In-place softmax over columns [off, off + n) of each row.
__device__ void softmax_rows(float* S, int ld, int off, int n) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = warp; r < TQ; r += NT / 32) {
    float* s = S + r * ld + off;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(s[j] - mx);
      s[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < n; j += 32) s[j] /= sum;
  }
}

struct Args {
  const bf16 *h, *kT, *vT, *kI, *vI, *wq, *wout, *wpa, *wpg, *wo;
  const float *ln2g, *ln2b, *bout, *ln3g, *ln3b, *bpa, *bpg, *bo;
  bf16* out;
  int S, C, H, St, K, F;
};

struct Layout {
  int ldc, ldd, lds, ldf;
  int xs, hs, qs, os, sc, ag, wst, total;  // float offsets / count
};

// Row stride for n floats, 4 mod 8: the 8 rows of an A fragment fall in
// distinct banks.
__host__ __device__ inline int pad(int n) { return (n + 7) / 8 * 8 + 4; }

__host__ __device__ inline Layout layout(int C, int d, int St, int K) {
  Layout L;
  L.ldc = pad(C);
  L.ldd = pad(d);
  L.lds = pad(St + K);
  L.ldf = pad(2 * FC);
  L.xs = 0;
  L.hs = L.xs + TQ * L.ldc;
  L.qs = L.hs + TQ * L.ldc;
  L.os = L.qs + TQ * L.ldd;
  L.sc = L.os + TQ * L.ldd;
  L.ag = L.sc + TQ * L.lds;
  L.wst = L.ag + TQ * L.ldf;
  L.total = L.wst + WST;  // two bf16 tiles
  return L;
}

__global__ void __launch_bounds__(NT) fused_cross_ff_kernel(Args a) {
  extern __shared__ float smem[];
  const int C = a.C, H = a.H, St = a.St, K = a.K, F = a.F;
  const int d = C / H;
  const Layout L = layout(C, d, St, K);
  float* xs = smem + L.xs;  // the residual stream; both sub-layers add into it
  float* hs = smem + L.hs;
  float* qs = smem + L.qs;
  float* os = smem + L.os;
  float* sc = smem + L.sc;
  float* ag = smem + L.ag;
  bf16* wst = reinterpret_cast<bf16*>(smem + L.wst);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TQ;
  const int nr = min(TQ, a.S - r0);
  const float scale = 1.f / sqrtf(static_cast<float>(d));

  const bf16* hb = a.h + ((long long)b * a.S + r0) * C;
  for (int idx = tid; idx < TQ * C; idx += NT) {
    const int r = idx / C, c = idx % C;
    xs[r * L.ldc + c] = r < nr ? pv::ld(hb + (long long)r * C + c) : 0.f;
  }
  __syncthreads();

  // ---- LN2 + dual-context cross-attention, one head at a time ----
  layernorm(xs, hs, L.ldc, C, a.ln2g, a.ln2b);
  for (int hh = 0; hh < H; ++hh) {
    const long long ctx_t = ((long long)b * H + hh) * St * d;
    const long long ctx_i = ((long long)b * H + hh) * K * d;
    gemm<false, false>(hs, L.ldc, C, a.wq + (long long)hh * C * d, d, d, qs, L.ldd, wst);
    for (int idx = tid; idx < TQ * d; idx += NT) {
      float* p = qs + (idx / d) * L.ldd + idx % d;
      *p *= scale;
    }
    __syncthreads();
    gemm<false, true>(qs, L.ldd, d, a.kT + ctx_t, d, St, sc, L.lds, wst);
    gemm<false, true>(qs, L.ldd, d, a.kI + ctx_i, d, K, sc + St, L.lds, wst);
    softmax_rows(sc, L.lds, 0, St);
    softmax_rows(sc, L.lds, St, K);
    __syncthreads();
    gemm<false, false>(sc, L.lds, St, a.vT + ctx_t, d, d, os, L.ldd, wst);
    gemm<true, false>(sc + St, L.lds, K, a.vI + ctx_i, d, d, os, L.ldd, wst);
    // the head's share of to_out, straight into the residual (LN2 is done)
    gemm<true, false>(os, L.ldd, d, a.wout + (long long)hh * d * C, C, C, xs, L.ldc, wst);
  }
  for (int idx = tid; idx < TQ * C; idx += NT) xs[idx / C * L.ldc + idx % C] += a.bout[idx % C];
  __syncthreads();

  // ---- LN3 + GEGLU, streamed over F ----
  layernorm(xs, hs, L.ldc, C, a.ln3g, a.ln3b);
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int fn = min(FC, F - f0);
    gemm<false, false>(hs, L.ldc, C, a.wpa + f0, F, fn, ag, L.ldf, wst);
    gemm<false, false>(hs, L.ldc, C, a.wpg + f0, F, fn, ag + FC, L.ldf, wst);
    for (int idx = tid; idx < TQ * fn; idx += NT) {
      const int r = idx / fn, j = idx % fn;
      float* pa = ag + r * L.ldf + j;
      const float gv = pa[FC] + a.bpg[f0 + j];
      *pa = (*pa + a.bpa[f0 + j]) * (0.5f * gv * (1.f + erff(gv * 0.70710678118654752f)));
    }
    __syncthreads();
    gemm<true, false>(ag, L.ldf, fn, a.wo + (long long)f0 * C, C, C, xs, L.ldc, wst);
  }

  bf16* ob = a.out + ((long long)b * a.S + r0) * C;
  for (int idx = tid; idx < nr * C; idx += NT) {
    const int r = idx / C, c = idx % C;
    ob[(long long)r * C + c] = __float2bfloat16(xs[r * L.ldc + c] + a.bo[c]);
  }
}

}  // namespace

// h/out (B, S, C) bf16 contiguous; kT/vT (B, H, St, d) and kI/vI (B, H, K, d)
// bf16; wq (H, C, d), wout (H, d, C), wpa/wpg (C, F), wo (F, C) bf16; the
// LayerNorm parameters and biases f32. Returns cudaGetLastError().
extern "C" int pv_fused_cross_ff(const void* h, void* out, const void* kT, const void* vT,
                                 const void* kI, const void* vI, const void* ln2g,
                                 const void* ln2b, const void* wq, const void* wout,
                                 const void* bout, const void* ln3g, const void* ln3b,
                                 const void* wpa, const void* wpg, const void* bpa,
                                 const void* bpg, const void* wo, const void* bo, int B,
                                 int S, int C, int H, int St, int K, int F, void* stream) {
  // weight and context rows are copied 8 bf16 at a time
  if (B <= 0 || S <= 0 || H <= 0 || C % H != 0 || St <= 0 || K <= 0 || F <= 0 || C % 8 != 0 ||
      (C / H) % 8 != 0 || F % 8 != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.h = static_cast<const bf16*>(h);
  a.kT = static_cast<const bf16*>(kT);
  a.vT = static_cast<const bf16*>(vT);
  a.kI = static_cast<const bf16*>(kI);
  a.vI = static_cast<const bf16*>(vI);
  a.wq = static_cast<const bf16*>(wq);
  a.wout = static_cast<const bf16*>(wout);
  a.wpa = static_cast<const bf16*>(wpa);
  a.wpg = static_cast<const bf16*>(wpg);
  a.wo = static_cast<const bf16*>(wo);
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
  a.C = C;
  a.H = H;
  a.St = St;
  a.K = K;
  a.F = F;
  const int smem = layout(C, C / H, St, K).total * static_cast<int>(sizeof(float));
  if (smem > 232448) return cudaErrorInvalidValue;  // Hopper's per-block limit
  cudaError_t err = pv::allow_smem(fused_cross_ff_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + TQ - 1) / TQ, B);
  fused_cross_ff_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
