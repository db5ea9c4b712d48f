// Shared helpers for the photoverse_tpu_torch kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pv {

// Two neighbouring bf16 values as one 32-bit word (4-byte aligned).
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major).
// With g = lane / 4 and t = lane % 4, each register two bf16 neighbours
// along k:
//   a = {A[g][2t:2t+2], A[g+8][2t:2t+2], A[g][2t+8:2t+10], A[g+8][2t+8:2t+10]},
//   b = {B[2t:2t+2][g], B[2t+8:2t+10][g]},
//   c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sets the dynamic shared-memory limit of `kernel` to `bytes` on the
// current device. The attribute is per device, so the launchers call this
// before every launch rather than once per process.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace pv
