"""Micro-benchmarks behind the flash backward's design, on one H100.

    python3 scripts/torch_wgmma_micro.py

Builds three small CUDA programs against the headers in
`photoverse_tpu_torch/csrc/` with nvcc (sm_90a) into a temporary directory
and runs them; needs no PyTorch. `wgmma`: clocks per wgmma for the shapes
the backward launches (64x64x16 with A and B from shared memory or A from
registers, 64x40x16 and 64x80x16 with A from registers and MN-major B, and
the dq kernel's mix at d = 40), from one, two and three warpgroups on an SM,
each batch waited for. `elementwise`: clocks for the backward's work on 32
scores a thread (exp by FFMA + MUFU.EX2, ds by FADD + FMUL, the bf16 packing
by F2FP or by integer ops), with one and two warps on each of an SM's four
schedulers. `mix`: one warpgroup running the dq kernel's batch of ten
products and another doing the exp work, each alone and both at once on
every SM: how far the two overlap. Prints the card's name and power limit
first.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "photoverse_tpu_torch", "csrc")

WGMMA = r"""// micro-benchmark: clocks per wgmma for the shapes the backward uses
#include <cstdio>
#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_gen.cuh"

// KIND 0: SS n64 k-major, 1: RSK n64, 2: RS n40 (mn-major B), 3: RS n80, 4: mix of the dq tile d=40 (3+3 rsk n64, 4 rs n40)
template <int KIND, int BATCH>
__global__ void __launch_bounds__(384, 1) bench(long long* out, int iters) {
  extern __shared__ unsigned char raw[];
  unsigned char* sm = raw + ((1024 - (pv::smem_u32(raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < 48 * 1024 / 4; i += blockDim.x) reinterpret_cast<uint32_t*>(sm)[i] = 0x3c003c00u;
  __syncthreads();
  const uint32_t base = pv::smem_u32(sm);
  const int wg = threadIdx.x / 128;
  float a0[32], a1[32], o40[20], o80[40];
  for (int i = 0; i < 32; ++i) a0[i] = a1[i] = 0.f;
  for (int i = 0; i < 20; ++i) o40[i] = 0.f;
  for (int i = 0; i < 40; ++i) o80[i] = 0.f;
  uint32_t fr[4] = {0x3c003c00u, 0x3c003c00u, 0x3c003c00u, 0x3c003c00u};
  const uint32_t mine = base + wg * 8192;
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    pv::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const uint32_t b = base + 24576 + (j % 4) * 32;
      if (KIND == 0) pv::wgmma_ss<64>(j & 1 ? a1 : a0, pv::desc_kmajor(mine + (j % 4) * 32), pv::desc_kmajor(b), 1);
      if (KIND == 1) pv::wgmma_rsk<64>(j & 1 ? a1 : a0, fr, pv::desc_kmajor(b), 1);
      if (KIND == 2) pv::wgmma_rs<40>(o40, fr, pv::desc_mnmajor(base + 24576 + (j % 4) * 2048, 8192), 1);
      if (KIND == 3) pv::wgmma_rs<80>(o80, fr, pv::desc_mnmajor(base + 24576 + (j % 4) * 2048, 8192), 1);
      if (KIND == 4) {
        if (j < 3) pv::wgmma_rsk<64>(a0, fr, pv::desc_kmajor(b), 1);
        else if (j < 6) pv::wgmma_rsk<64>(a1, fr, pv::desc_kmajor(b), 1);
        else pv::wgmma_rs<40>(o40, fr, pv::desc_mnmajor(base + 24576 + (j % 4) * 2048, 8192), 1);
      }
    }
    pv::wgmma_commit();
    pv::wgmma_wait<0>();
  }
  long long t1 = clock64();
  float s = 0;
  for (int i = 0; i < 32; ++i) s += a0[i] + a1[i];
  for (int i = 0; i < 20; ++i) s += o40[i];
  for (int i = 0; i < 40; ++i) s += o80[i];
  if (threadIdx.x % 128 == 0) out[blockIdx.x * 4 + wg] = (t1 - t0) + (s == 123.f);
}

template <int KIND, int BATCH>
void run(const char* name, int nwg) {
  long long* d;
  cudaMalloc(&d, 132 * 4 * 8);
  auto k = bench<KIND, BATCH>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 64 * 1024);
  const int iters = 2000;
  k<<<132, 128 * nwg, 64 * 1024>>>(d, iters);
  k<<<132, 128 * nwg, 64 * 1024>>>(d, iters);
  cudaError_t e = cudaDeviceSynchronize();
  long long h[132 * 4];
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  printf("%-10s batch %2d warpgroups %d: %7.1f clk per wgmma per warpgroup, %7.1f clk per wgmma on the SM (%s)\n", name, BATCH, nwg,
         double(h[0]) / iters / BATCH, double(h[0]) / iters / BATCH / nwg, cudaGetErrorString(e));
  cudaFree(d);
}

int main() {
  for (int nwg = 1; nwg <= 3; ++nwg) {
    run<0, 4>("ss n64", nwg); run<0, 8>("ss n64", nwg);
    run<1, 4>("rsk n64", nwg); run<1, 8>("rsk n64", nwg);
    run<2, 4>("rs n40", nwg); run<2, 8>("rs n40", nwg);
    run<3, 4>("rs n80", nwg); run<3, 8>("rs n80", nwg);
    run<4, 10>("dq d40 mix", nwg);
  }
  return 0;
}
"""

MIX = r"""// does a warpgroup's exp work run beside another warpgroup's wgmmas?
#include <cstdio>
#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_gen.cuh"

// MODE bit 0: warpgroup 0 runs wgmma batches; bit 1: warpgroup 1 does exp work
template <int MODE>
__global__ void __launch_bounds__(256, 1) bench(long long* out, float* sink, int iters, float c) {
  extern __shared__ unsigned char raw[];
  unsigned char* sm = raw + ((1024 - (pv::smem_u32(raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < 48 * 1024 / 4; i += blockDim.x) reinterpret_cast<uint32_t*>(sm)[i] = 0x3c003c00u;
  __syncthreads();
  const uint32_t base = pv::smem_u32(sm);
  const int wg = threadIdx.x / 128;
  long long t0 = clock64(), t1 = t0;
  if (wg == 0 && (MODE & 1)) {
    float a0[32], a1[32], o40[20];
    for (int i = 0; i < 32; ++i) a0[i] = a1[i] = 0.f;
    for (int i = 0; i < 20; ++i) o40[i] = 0.f;
    uint32_t fr[4] = {0x3c003c00u, 0x3c003c00u, 0x3c003c00u, 0x3c003c00u};
    for (int it = 0; it < iters; ++it) {
      pv::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 10; ++j) {
        const uint32_t b = base + 24576 + (j % 4) * 32;
        if (j < 3) pv::wgmma_rsk<64>(a0, fr, pv::desc_kmajor(b), 1);
        else if (j < 6) pv::wgmma_rsk<64>(a1, fr, pv::desc_kmajor(b), 1);
        else pv::wgmma_rs<40>(o40, fr, pv::desc_mnmajor(base + 24576 + (j % 4) * 2048, 8192), 1);
      }
      pv::wgmma_commit();
      pv::wgmma_wait<0>();
    }
    t1 = clock64();
    float s = 0;
    for (int i = 0; i < 32; ++i) s += a0[i] + a1[i];
    for (int i = 0; i < 20; ++i) s += o40[i];
    if (s == 123.f) sink[1] = s;
  }
  if (wg == 1 && (MODE & 2)) {
    float sc[32], dp[32];
    for (int i = 0; i < 32; ++i) { sc[i] = threadIdx.x * 1e-3f + i; dp[i] = i * 0.5f; }
    uint32_t acc = 0;
    for (int it = 0; it < iters; ++it) {
      float x[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        x[i] = pv::fast_exp2(fmaf(sc[i], c, -dp[i & 1]));
        x[i] *= dp[i] - dp[(i >> 1) & 1];
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) acc ^= pv::pack_bf16(x[2 * i], x[2 * i + 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] += 1e-3f * (acc & 1);
    }
    t1 = clock64();
    if (acc == 12345u) sink[0] = sc[3];
  }
  if (threadIdx.x % 128 == 0) out[blockIdx.x * 2 + wg] = t1 - t0;
}

template <int MODE>
void run(const char* name) {
  long long* d; float* s;
  cudaMalloc(&d, 132 * 2 * 8); cudaMalloc(&s, 8);
  auto k = bench<MODE>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 64 * 1024);
  const int iters = 2000;
  k<<<132, 256, 64 * 1024>>>(d, s, iters, 0.2f);
  k<<<132, 256, 64 * 1024>>>(d, s, iters, 0.2f);
  cudaError_t e = cudaDeviceSynchronize();
  long long h[2];
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  printf("%-44s: products %6.1f clk a batch of ten, exp work %6.1f clk per 32 scores (%s)\n", name,
         double(h[0]) / iters, double(h[1]) / iters, cudaGetErrorString(e));
}

int main() {
  run<1>("one warpgroup's products alone");
  run<2>("one warpgroup's exp work alone");
  run<3>("both, on one SM at the same time");
  return 0;
}
"""

ELEMENTWISE = r"""// micro-benchmark: clocks for the backward's elementwise work on 32 scores a thread
#include <cstdio>
#include "common.cuh"
#include "hopper.cuh"

// MODE bit 0: exp (FFMA + MUFU), bit 1: ds (FADD + FMUL), bit 2: pack (F2FP), bit 3: pack by integer ops
template <int MODE>
__global__ void __launch_bounds__(256, 1) bench(long long* out, float* sink, int iters, float c) {
  float sc[32], dp[32];
  for (int i = 0; i < 32; ++i) { sc[i] = threadIdx.x * 1e-3f + i; dp[i] = i * 0.5f; }
  uint32_t acc = 0;
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      x[i] = sc[i];
      if (MODE & 1) x[i] = pv::fast_exp2(fmaf(x[i], c, -dp[i & 1]));
      if (MODE & 2) x[i] *= dp[i] - dp[(i >> 1) & 1];
    }
    if (MODE & 4) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc ^= pv::pack_bf16(x[2 * i], x[2 * i + 1]);
    } else if (MODE & 8) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t a = __float_as_uint(x[2 * i]) + 0x8000u, b = __float_as_uint(x[2 * i + 1]) + 0x8000u;
        acc ^= __byte_perm(a, b, 0x7632);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc ^= __float_as_uint(x[i]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] += 1e-3f * (acc & 1);  // keeps the loop from folding
  }
  long long t1 = clock64();
  if (threadIdx.x % 32 == 0) out[blockIdx.x * 8 + threadIdx.x / 32] = t1 - t0;
  if (acc == 12345u) sink[0] = sc[3];
}

template <int MODE>
void run(const char* name, int warps) {
  long long* d; float* s;
  cudaMalloc(&d, 132 * 8 * 8); cudaMalloc(&s, 4);
  const int iters = 2000;
  bench<MODE><<<132, 32 * warps>>>(d, s, iters, 0.2f);
  bench<MODE><<<132, 32 * warps>>>(d, s, iters, 0.2f);
  cudaDeviceSynchronize();
  long long h[8];
  cudaMemcpy(h, d, sizeof(h), cudaMemcpyDeviceToHost);
  printf("%-34s warps on each of the SM's 4 schedulers %d: %6.1f clk per 32 scores a thread\n", name, warps / 4, double(h[0]) / iters);
}

int main() {
  for (int w = 4; w <= 8; w += 4) {
    run<0>("loop overhead (32 FADD + xor)", w);
    run<1>("exp (FFMA + MUFU.EX2)", w);
    run<2>("ds (FADD + FMUL)", w);
    run<4>("pack (F2FP)", w);
    run<8>("pack by IADD + PRMT (round half up)", w);
    run<7>("exp + ds + F2FP pack", w);
    run<11>("exp + ds + integer pack", w);
  }
  return 0;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        print("needs nvcc and an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, source in (("wgmma", WGMMA), ("elementwise", ELEMENTWISE), ("mix", MIX)):
            cu, exe = os.path.join(tmp, name + ".cu"), os.path.join(tmp, name)
            with open(cu, "w") as f:
                f.write(source)
            build = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                                    "-I", CSRC, "-o", exe, cu], capture_output=True, text=True)
            if build.returncode != 0:
                print(build.stdout + build.stderr, file=sys.stderr)
                return 1
            print(f"-- {name}", flush=True)
            rc |= subprocess.run([exe], timeout=120).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
