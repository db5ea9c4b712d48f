// GroupNorm over channels-last activations, with the ResNet block's
// time-embedding add before it and the SiLU after it fused in: the kernel
// behind `ops/group_norm.py:group_norm_nhwc`, which the UNet's and the VAE's
// no-grad forwards take for every GroupNorm (models/layers.py).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm, the add and the
// SiLU to XLA, which fuses them into the convolutions' neighbourhood. On the
// card PyTorch's group_norm wants NCHW (a copy of every channels-last input),
// launches three kernels and writes its output for a separate SiLU and add
// to read again. This one reads x (N, H, W, C) and, per (n, group) over H W
// and the group's channels, computes the mean and the biased variance in
// f32, then y = x * a + b per channel with a = rstd * weight and b = bias -
// mean * a, optionally SiLU, rounded once to the output type. With `add`
// (N, C) the input is round(x + add[n, c]) in x's type, what the unfused
// add wrote, and x + add is never written.
//
// What bounds it on an H100: bytes. One read and one write of x (the bound
// in ops/bounds.py:group_norm); no matrix product. The UNet's norms at batch
// 16 hold 1.3-42 MB each and the VAE decoder's last level 512^2 x 128 at
// batch 8 holds 537 MB, while one image has only 32 groups, far too few
// work items for 132 SMs at batch 1. What the design does about it:
//   - Three launches from one call. Stats: the H W pixels of an image are
//     cut into chunks and each block reduces its chunk for all groups at
//     once, so the grid fills the card at any batch. Finalize: one warp a
//     (n, group) folds the chunks' partials. Apply: the same chunks again,
//     each block reading its (n, group) statistics from the 256 bytes a
//     batch row holds. x is read twice (the second read often from the 50
//     MB L2) and written once.
//   - A block's threads are (C / VEC) x rows: thread (tx, ty) always loads
//     the same VEC channels (one 16-byte vector, 8 bf16 or 4 f32) of pixels
//     ty, ty + rows, ..., so a block reads rows whole pixels, contiguous in
//     NHWC, per step, four steps' loads in flight, and keeps its channels'
//     weight, bias and add in registers. A group's 4-80 channels are never
//     read on their own.
//   - Moments without cancellation: each thread sums x - s and (x - s)^2
//     per channel with s its first value of that channel; the block then
//     combines (count, mean, M2) triples per group by Chan's rule in a fixed
//     order (shared memory, then a warp's butterfly), and so does finalize:
//     no atomics, the same bits on every run.
//   - Another type or a channel count that is no multiple of VEC takes the
//     same kernels with VEC = 1.

#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;   // per block, rounded to whole pixel rows
constexpr int MAX_COLS = 512;  // vectors a pixel row may hold (C <= 4096 in bf16)
constexpr int UNROLL = 4;      // loads a thread keeps in flight

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// VEC consecutive values of T as f32; one 16-byte access when VEC fills it
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_f<T>(v[j]);
  }
}

// (n, mean, m2) <- the union of itself and (nb, mb, m2b), Chan et al.
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nt = n + nb, f = nb / nt, d = mb - mean;
  mean = fmaf(d, f, mean);
  m2 += m2b + d * d * n * f;
  n = nt;
}

// the triple of lane 0 after a butterfly over the warp (the same order
// every run)
__device__ __forceinline__ void chan_warp(float& n, float& mean, float& m2) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, off);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, off);
    const float qb = __shfl_xor_sync(0xffffffffu, m2, off);
    chan(n, mean, m2, nb, mb, qb);
  }
}

// Block (chunk, n): partial[n][chunk][g] = (mean, M2) of group g over the
// chunk's pixels [p0, p1); its count is (p1 - p0) * C / G.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_COLS) gn_stats_kernel(const T* __restrict__ x, const T* __restrict__ add,
                                                        float2* __restrict__ partial, int HW, int C, int G,
                                                        int per_chunk) {
  extern __shared__ float smem[];
  const int cols = blockDim.x, rows = blockDim.y, tx = threadIdx.x, ty = threadIdx.y;
  const int n = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int p0 = chunk * per_chunk, p1 = min(HW, p0 + per_chunk);
  const int c0 = tx * VEC;
  const T* xn = x + static_cast<long long>(n) * HW * C + c0;
  float t[VEC] = {};
  if (add != nullptr) load_vec<T, VEC>(add + static_cast<long long>(n) * C + c0, t);

  float s[VEC] = {}, s1[VEC] = {}, s2[VEC] = {};
  int cnt = 0;
  int p = p0 + ty;
  if (p < p1) load_vec<T, VEC>(xn + static_cast<long long>(p) * C, s);
  if (add != nullptr) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = to_f(from_f<T>(s[j] + t[j]));
  }
  auto accumulate = [&](const float(&v)[VEC]) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float u = add != nullptr ? to_f(from_f<T>(v[j] + t[j])) : v[j];
      const float d = u - s[j];
      s1[j] += d;
      s2[j] = fmaf(d, d, s2[j]);
    }
  };
  for (; p + (UNROLL - 1) * rows < p1; p += UNROLL * rows, cnt += UNROLL) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) load_vec<T, VEC>(xn + static_cast<long long>(p + u * rows) * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) accumulate(v[u]);
  }
  for (; p < p1; p += rows, ++cnt) {
    float v[VEC];
    load_vec<T, VEC>(xn + static_cast<long long>(p) * C, v);
    accumulate(v);
  }

  float* s_mean = smem;
  float* s_m2 = smem + rows * C;
  float* s_cnt = smem + 2 * rows * C;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float mean = 0.f, m2 = 0.f;
    if (cnt > 0) {
      const float inv = 1.f / static_cast<float>(cnt);
      mean = fmaf(s1[j], inv, s[j]);
      m2 = fmaxf(s2[j] - s1[j] * s1[j] * inv, 0.f);
    }
    s_mean[ty * C + c0 + j] = mean;
    s_m2[ty * C + c0 + j] = m2;
  }
  if (tx == 0) s_cnt[ty] = static_cast<float>(cnt);
  __syncthreads();

  // a warp per group over its channels x rows entries; whole warps only
  const int tid = ty * cols + tx, warp = tid >> 5, lane = tid & 31, warps = (cols * rows) >> 5;
  const int cpg = C / G;
  if (warp >= warps) return;
  for (int g = warp; g < G; g += warps) {
    float nn = 0.f, mean = 0.f, m2 = 0.f;
    for (int e = lane; e < cpg * rows; e += 32) {
      const int r = e / cpg, ch = g * cpg + (e - r * cpg);
      chan(nn, mean, m2, s_cnt[r], s_mean[r * C + ch], s_m2[r * C + ch]);
    }
    chan_warp(nn, mean, m2);
    if (lane == 0) partial[(static_cast<long long>(n) * chunks + chunk) * G + g] = make_float2(mean, m2);
  }
}

// stats[n][g] = (mean, rstd) from the chunks' partials; a warp per (n, g)
__global__ void gn_finalize_kernel(const float2* __restrict__ partial, float2* __restrict__ stats, int N,
                                   int HW, int C, int G, int chunks, int per_chunk, float eps) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= N * G) return;
  const int n = item / G, g = item - n * G;
  const float cpg = static_cast<float>(C / G);
  float nn = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = lane; k < chunks; k += 32) {
    const int p0 = k * per_chunk, p1 = min(HW, p0 + per_chunk);
    const float2 v = partial[(static_cast<long long>(n) * chunks + k) * G + g];
    chan(nn, mean, m2, static_cast<float>(max(p1 - p0, 0)) * cpg, v.x, v.y);
  }
  chan_warp(nn, mean, m2);
  if (lane == 0) stats[item] = make_float2(mean, 1.f / sqrtf(m2 / nn + eps));
}

// Block (chunk, n): y = [silu](round(x + add) * a + b) over the chunk's
// pixels, a and b per channel from stats, weight and bias.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_COLS) gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ add,
                                                        const void* __restrict__ weight,
                                                        const void* __restrict__ bias, int w_bf16,
                                                        const float2* __restrict__ stats, T* __restrict__ out,
                                                        int HW, int C, int G, int per_chunk, int silu) {
  const int rows = blockDim.y, tx = threadIdx.x, ty = threadIdx.y;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * per_chunk, p1 = min(HW, p0 + per_chunk);
  const int c0 = tx * VEC, cpg = C / G;
  float a[VEC], b[VEC], t[VEC] = {};
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = c0 + j;
    const float2 st = stats[n * G + c / cpg];
    const float w = w_bf16 ? to_f(static_cast<const bf16*>(weight)[c]) : static_cast<const float*>(weight)[c];
    const float bb = w_bf16 ? to_f(static_cast<const bf16*>(bias)[c]) : static_cast<const float*>(bias)[c];
    a[j] = st.y * w;
    b[j] = fmaf(-a[j], st.x, bb);
  }
  if (add != nullptr) load_vec<T, VEC>(add + static_cast<long long>(n) * C + c0, t);
  const long long base = static_cast<long long>(n) * HW * C + c0;
  auto apply = [&](float(&v)[VEC]) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float u = add != nullptr ? to_f(from_f<T>(v[j] + t[j])) : v[j];
      const float y = fmaf(u, a[j], b[j]);
      v[j] = silu ? y / (1.f + expf(-y)) : y;
    }
  };
  int p = p0 + ty;
  for (; p + (UNROLL - 1) * rows < p1; p += UNROLL * rows) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) load_vec<T, VEC>(x + base + static_cast<long long>(p + u * rows) * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      apply(v[u]);
      store_vec<T, VEC>(out + base + static_cast<long long>(p + u * rows) * C, v[u]);
    }
  }
  for (; p < p1; p += rows) {
    float v[VEC];
    load_vec<T, VEC>(x + base + static_cast<long long>(p) * C, v);
    apply(v);
    store_vec<T, VEC>(out + base + static_cast<long long>(p) * C, v);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* add, const void* weight, const void* bias, void* out, void* work,
                   int N, int HW, int C, int G, int chunks, float eps, int w_bf16, int silu,
                   cudaStream_t stream) {
  const int cols = C / VEC;
  if (cols > MAX_COLS) return cudaErrorInvalidValue;
  const int rows = max(1, THREADS / cols);
  const int per_chunk = (HW + chunks - 1) / chunks;
  chunks = (HW + per_chunk - 1) / per_chunk;  // no empty chunk
  const int smem = (2 * rows * C + rows) * static_cast<int>(sizeof(float));  // <= 32 KB
  float2* partial = static_cast<float2*>(work);
  float2* stats = partial + static_cast<long long>(N) * chunks * G;
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(add);
  const dim3 block(cols, rows), grid(chunks, N);
  gn_stats_kernel<T, VEC><<<grid, block, smem, stream>>>(xt, at, partial, HW, C, G, per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps = 8;
  gn_finalize_kernel<<<(N * G + warps - 1) / warps, 32 * warps, 0, stream>>>(partial, stats, N, HW, C, G, chunks,
                                                                             per_chunk, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T, VEC><<<grid, block, 0, stream>>>(xt, at, weight, bias, w_bf16, stats, static_cast<T*>(out),
                                                      HW, C, G, per_chunk, silu);
  return cudaGetLastError();
}

}  // namespace

// x, add (or null), out: (N, H, W, C) contiguous of one type (x_bf16: bf16,
// else f32), add (N, C); weight, bias (C,) (w_bf16: bf16, else f32); work:
// f32 scratch of 2 * G * N * (chunks + 1) values.
extern "C" int pv_group_norm_nhwc(const void* x, const void* add, const void* weight, const void* bias, void* out,
                                  void* work, int N, int HW, int C, int G, int chunks, float eps, int x_bf16,
                                  int w_bf16, int silu, void* stream) {
  if (N <= 0 || HW <= 0 || C <= 0 || G <= 0 || C % G != 0 || chunks <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(add);
  const bool aligned = ptrs % 16 == 0;
  if (x_bf16) {
    if (aligned && C % 8 == 0)
      return launch<bf16, 8>(x, add, weight, bias, out, work, N, HW, C, G, chunks, eps, w_bf16, silu, s);
    return launch<bf16, 1>(x, add, weight, bias, out, work, N, HW, C, G, chunks, eps, w_bf16, silu, s);
  }
  if (aligned && C % 4 == 0)
    return launch<float, 4>(x, add, weight, bias, out, work, N, HW, C, G, chunks, eps, w_bf16, silu, s);
  return launch<float, 1>(x, add, weight, bias, out, work, N, HW, C, G, chunks, eps, w_bf16, silu, s);
}
