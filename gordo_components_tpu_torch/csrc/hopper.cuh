// Hopper building blocks shared by the bf16 flash kernels
// (flash_fwd_bf16.cu, flash_bwd_bf16.cu): mbarriers, TMA and plain copies
// into 128-byte-swizzled 64 x 64 bf16 tiles, wgmma on those tiles, the
// tensor-map encoder and the SM count. Everything here has internal
// linkage: each source that includes it is a library of its own, and
// ops/_kernels.py hashes this header into the name of every library whose
// source includes it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;                // rows (q or keys) per tile
constexpr int TILE_BYTES = TILE * 128;  // 64 rows x 64 bf16 columns
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase with this parity has completed. A debug build
// (-DCUDA_KERNEL_DEBUG) traps after about 4 s of waiting, so that a fault in
// the pipeline shows as a launch failure rather than a hang; the served
// build waits without a limit, since a trap leaves the CUDA context unusable
// and a correct wait can stretch under time-slicing or a debugger
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
#ifdef CUDA_KERNEL_DEBUG
  const long long start = clock64();
#endif
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
#ifdef CUDA_KERNEL_DEBUG
    if (clock64() - start > 8000000000LL) asm volatile("trap;");
#endif
  }
}

// ---- TMA and plain copies ---------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// byte offset of element (r, c) in NH swizzled 64 x 64 bf16 tiles, as TMA's
// 128-byte swizzle lays them out: 16-byte chunk k of row r at k ^ (r % 8)
__device__ __forceinline__ int swizzled(int r, int c) {
  const int cc = c % 64;
  return (c / 64) * TILE_BYTES + r * 128 + (((cc / 8) ^ (r % 8)) << 4) + (cc % 8) * 2;
}

// One warp copies rows [row0, row0 + 64) x columns [0, 64 NH) of sequence
// `seq_base` into NH swizzled 64 x 64 tiles, zero-filling rows at or past
// `seq` and columns at or past `d`.
template <int NH>
__device__ __forceinline__ void plain_copy(uint8_t* dst, const bf16* seq_base, int row0, int seq,
                                           int d, int lane) {
  constexpr int CHUNKS = 16 * NH;  // 8-byte chunks (4 bf16) per row
  for (int i = lane; i < TILE * CHUNKS; i += 32) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    uint2 val = make_uint2(0u, 0u);
    if (row0 + r < seq && c < d)
      val = *reinterpret_cast<const uint2*>(seq_base + (size_t)(row0 + r) * d + c);
    *reinterpret_cast<uint2*>(dst + swizzled(r, c)) = val;
  }
}

// after a warp's plain copies: make them visible to wgmma (the async
// proxy), then release `bar` (one arrival)
__device__ __forceinline__ void plain_release(uint64_t* bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int NH>
__device__ __forceinline__ void plain_load(uint8_t* dst, const bf16* seq_base, int row0, int seq,
                                           int d, uint64_t* bar, int lane) {
  plain_copy<NH>(dst, seq_base, row0, seq, d, lane);
  plain_release(bar, lane);
}

// ---- wgmma ----------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle, 1024-byte aligned
// tiles: 8-row groups 1024 bytes apart (SBO); LBO is unused by these layouts
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint32_t addr = smem_u32(tile);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous product
__device__ __forceinline__ void fence_regs(float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

#define WG_D32(d)                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_REGS32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 fp32) (+)= A (64 x 16, K-major smem) * B (16 x 64, K-major smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 fp32) (+)= A (64 x 16, MN-major smem) * B (16 x 64, MN-major
// smem): both operands stored with K as the row and M or N contiguous
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- host side ----------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 3-D map over (BH, S, D), innermost first, box (64 columns, 64 rows, 1 bh):
// rows past S and columns past D are zero-filled, never the next sequence's
bool make_map(CUtensorMap* map, const void* ptr, int bh, int seq, int d) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)seq * d * 2};
  const cuuint32_t box[3] = {64, TILE, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the current device's SM count, read once per device (the attribute
// query costs about 0.1 ms of host time, more than a launch)
cudaError_t sm_count(int* sms) {
  static int cached[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && cached[device] > 0) {
    *sms = cached[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device < 64) cached[device] = *sms;
  return err;
}

}  // namespace
