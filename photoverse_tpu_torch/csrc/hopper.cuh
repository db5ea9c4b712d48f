// Hopper (sm_90a) building blocks for the wgmma kernels: mbarriers, TMA
// loads, shared-memory matrix descriptors, wgmma ordering, named barriers,
// and the host side of a TMA tensor map (encoded through the entry point
// the CUDA runtime hands out, so nothing links against libcuda).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

namespace pv {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (64-bit objects in shared memory) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// After the inits, before any other thread or the TMA unit touches a barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ----

// Orders generic-proxy writes to shared memory before async-proxy reads
// (wgmma operands, TMA stores) that follow a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ----

// Shared-memory matrix descriptors for tiles in the 128-byte swizzle, as a
// TMA box of 64 bf16 (128 bytes) per row lays them down at a 1024-byte
// aligned address: row r at r * 128, its 16-byte chunks XORed with r % 8.
// K-major (rows = M or N, the 64 columns = K): groups of 8 rows are 1024
// bytes apart; a k16 step inside the tile advances the address by 32 bytes.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// MN-major (rows = K, the 64 columns = N, for a B operand read with the
// transpose bit): groups of 8 k rows are 1024 bytes apart, the next 64
// columns of N are `slab_bytes` away; a k16 step advances by 2048 bytes.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t slab_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((slab_bytes & 0x3FFFF) >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

// The same descriptors in two halves, for a run of wgmmas over one tile:
// the low word holds the address (in 16-byte units, so a step of n bytes
// adds n / 16 to it) and, for MN-major, the slab distance; the high word
// is the same for every tile.
constexpr uint32_t DESC_HI = 64u | (1u << 30);
__device__ __forceinline__ uint32_t desc_lo_kmajor(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (1u << 16);
}
__device__ __forceinline__ uint32_t desc_lo_mnmajor(uint32_t addr, uint32_t slab_bytes) {
  return ((addr & 0x3FFFF) >> 4) | (((slab_bytes & 0x3FFFF) >> 4) << 16);
}
__device__ __forceinline__ uint64_t desc_join(uint32_t lo) {
  uint64_t d;
  asm("mov.b64 %0, {%1, %2};\n" : "=l"(d) : "r"(lo), "r"(DESC_HI));
  return d;
}

// Byte offset of element (r, c) of such a tile (c < 64).
__device__ __forceinline__ int swz128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the order of ordinary instructions on these registers against the
// asm statements around them. After a wait_group: the accumulators of an
// asynchronous wgmma are not read ahead of the wait that completes it.
// Before a wgmma.fence: what defines them is not moved behind it, where
// ptxas would have to serialise the wgmmas of the stage.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for operand fragments: what was computed into them stays ahead
// of the wgmma.fence that follows.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x on the special-function unit in one instruction (exp2f adds range
// handling around it); 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo with hi = bf16(x) and lo = bf16(x - hi): 16 significant bits
// of x in two bf16 operands. Packs the pairs (x0, x1).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  const __nv_bfloat162 h = __halves2bfloat162(h0, h1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qres;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &qres) != cudaSuccess ||
        qres != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &qres) !=
            cudaSuccess ||
        qres != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first, unit stride there;
// `strides` in elements for dims 1..rank-1), cut into boxes of `box`
// elements per dim whose innermost 64 elements (128 bytes) land in the
// 128-byte swizzle; what a box covers past the tensor's end reads as zero.
// The base must be 16-byte aligned and every stride a multiple of 8.
inline bool encode_bf16_map(CUtensorMap* map, const void* base, int rank, const long long* dims,
                            const long long* strides, const int* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr || rank < 2 || rank > 5) return false;
  cuuint64_t gdim[5], gstr[4];
  cuuint32_t bdim[5], estr[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bdim[i] = static_cast<cuuint32_t>(box[i]);
    estr[i] = 1;
    if (i > 0) gstr[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * 2;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), gdim, gstr, bdim,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same map from a small cache keyed by everything it is made from:
// encoding costs host time on every launch, and a denoise loop launches
// on the same few addresses and shapes again and again (the allocator
// hands freed blocks out again). A map holds no data, only the address
// and geometry, so a hit is always valid; the current device is part of
// the key. False if the encoding fails.
inline bool cached_bf16_map(CUtensorMap* out, const void* base, int rank, const long long* dims,
                            const long long* strides, const int* box) {
  typedef std::array<long long, 17> Key;
  static std::map<Key, CUtensorMap> cache;
  static std::mutex lock;
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return false;
  Key key{};
  key[16] = device;
  key[0] = reinterpret_cast<long long>(base);
  key[1] = rank;
  for (int i = 0; i < rank; ++i) {
    key[2 + i] = dims[i];
    key[7 + i] = box[i];
    if (i > 0) key[11 + i] = strides[i - 1];
  }
  std::lock_guard<std::mutex> hold(lock);
  auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return true;
  }
  if (cache.size() >= 4096) cache.clear();
  if (!encode_bf16_map(out, base, rank, dims, strides, box)) return false;
  cache.emplace(key, *out);
  return true;
}

}  // namespace pv
