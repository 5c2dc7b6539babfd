// Non-causal attention forward in bfloat16 on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`, launched by `_flash_fwd_3d`
// in gordo_components_tpu/ops/flash_attention.py (pl.pallas_call at :157).
// Same contract: q, k, v are (BH, S, D) bfloat16, contiguous; out is
// (BH, S, D) bfloat16 and lse is (BH, S) float32, the per-row logsumexp of
// the scaled scores. Keys at or beyond S are masked with -1e30, never -inf.
// D is any multiple of 4 up to 128, S any length >= 1.
//
// What bounds it on an H100: at the slice shape (BH 8192, S 179, D 64) one
// call moves 0.757 GB (q, k, v read once, out and lse written once), 0.226
// ms at 3.35 TB/s, while its 67.2 GFLOP take 0.068 ms at 989 TFLOP/s. So it
// is a streaming kernel: what it must get right is keeping loads in flight.
//
// What the design does about it:
// - Products on the tensor cores with fp32 accumulation: S = Q K^T is
//   `wgmma.m64n64k16` with Q and K K-major in shared memory (128-byte
//   swizzle: a 64-wide bf16 head row is one swizzle atom); the online
//   softmax runs in the accumulator registers, row max reduced over the 4
//   lanes that share a row; P goes to bf16 in registers and is the A
//   operand of O += P V (register-A `wgmma`), with V the B operand read
//   MN-major from shared memory (transpose bit set).
// - Copies by TMA, completed on mbarriers and issued by one producer warp,
//   into a ring of K/V stages and a double buffer of Q tiles per consumer
//   warpgroup. A 3-D tensor map over (BH, S, D) with box (1, 64, 64)
//   zero-fills rows past S (and columns past D), never the next sequence's.
// - Blocks are persistent, one per SM, and walk over bh: the producer keeps
//   the next sequence's Q, K and V in flight while three consumer
//   warpgroups (64 q rows each: S = 179 is three) compute this one. Longer
//   sequences loop over rounds of three q tiles.
// - A head_dim that is not a multiple of 8 breaks TMA's 16-byte stride
//   rule; the producer warp then copies the same swizzled tiles with plain
//   8-byte loads, inside this kernel.
// - D up to 64 is one 64-column tile (the rest zero-filled); D up to 128 is
//   two, with two accumulators for O.
//
// Resources (nvcc 12.8, -Xptxas -v, sm_90a; tools/flash_kernel_sweep.py):
// the served <NH = 1, NWG = 3, NST = 6> runs 416 threads at 106 registers
// with no spills, 240 bytes of static and 148,480 bytes of dynamic shared
// memory: one block per SM. <2, 3, 2> (D > 64): 128 registers, 48 bytes
// spilled. Measured at the slice shape (NVIDIA H100 80GB HBM3, 700 W):
// 0.34 ms, 2.25 TB/s, 67 % of the bytes bound (PERF.md, PR 2).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;                      // rows (q or keys) per tile
constexpr int TILE_BYTES = TILE * 128;        // 64 rows x 64 bf16 columns
constexpr float MASK = -1e30f;
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

// One warp copies rows [row0, row0 + 64) x columns [0, 64 NH) of sequence
// `seq_base` into NH swizzled 64 x 64 tiles, as TMA's 128-byte swizzle lays
// them out (16-byte chunk c of row r at chunk c ^ (r % 8)), zero-filling
// rows at or past `seq` and columns at or past `d`; then releases `bar`.
template <int NH>
__device__ __forceinline__ void plain_load(uint8_t* dst, const bf16* seq_base, int row0, int seq,
                                           int d, uint64_t* bar, int lane) {
  constexpr int CHUNKS = 16 * NH;  // 8-byte chunks (4 bf16) per row
  for (int i = lane; i < TILE * CHUNKS; i += 32) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    uint2 val = make_uint2(0u, 0u);
    if (row0 + r < seq && c < d)
      val = *reinterpret_cast<const uint2*>(seq_base + (size_t)(row0 + r) * d + c);
    const int h = c / 64, cc = c % 64;
    const int off = h * TILE_BYTES + r * 128 + (((cc / 8) ^ (r % 8)) << 4) + (cc % 8) * 2;
    *reinterpret_cast<uint2*>(dst + off) = val;
  }
  // the tiles are read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
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

// ---- the kernel -------------------------------------------------------------

// NH: 64-column halves of the head (1 for D <= 64, 2 up to 128); NWG:
// consumer warpgroups (q tiles computed at once); NST: K/V ring stages.
template <int NH, int NWG, int NST>
struct Smem {
  static constexpr int Q_BYTES = NWG * 2 * NH * TILE_BYTES;
  static constexpr int KV_BYTES = NST * NH * TILE_BYTES;
  static constexpr int BYTES = Q_BYTES + 2 * KV_BYTES + 1024;  // + alignment slack
};

template <int NH, int NWG, int NST>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const bf16* __restrict__ q,
                      const bf16* __restrict__ k, const bf16* __restrict__ v,
                      bf16* __restrict__ out, float* __restrict__ lse, int n_bh, int seq, int d,
                      float scale_log2, int use_tma) {
  __shared__ __align__(8) uint64_t q_full[NWG][2], q_empty[NWG][2];
  __shared__ __align__(8) uint64_t k_full[NST], v_full[NST], kv_empty[NST];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* q_tiles = base;                                   // [NWG][2][NH] tiles
  uint8_t* k_tiles = q_tiles + Smem<NH, NWG, NST>::Q_BYTES;  // [NST][NH] tiles
  uint8_t* v_tiles = k_tiles + Smem<NH, NWG, NST>::KV_BYTES; // [NST][NH] tiles

  const int n_tiles = (seq + TILE - 1) / TILE;  // q tiles = key tiles
  const int rounds = (n_tiles + NWG - 1) / NWG;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t seq_elems = (size_t)seq * d;

  if (threadIdx.x == 0) {
    for (int w = 0; w < NWG; ++w)
      for (int s = 0; s < 2; ++s) {
        mbar_init(&q_full[w][s], 1);
        mbar_init(&q_empty[w][s], 128);
      }
    for (int s = 0; s < NST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // ---- producer warp: Q tiles per consumer, then the round's K/V tiles
    auto load = [&](const CUtensorMap* map, const bf16* g, uint8_t* dst, uint64_t* bar, int bh,
                    int row0) {
      if (use_tma) {
        if (lane == 0) {
          mbar_expect_tx(bar, NH * TILE_BYTES);
#pragma unroll
          for (int h = 0; h < NH; ++h) tma_load_3d(dst + h * TILE_BYTES, map, 64 * h, row0, bh, bar);
        }
        __syncwarp();
      } else {
        plain_load<NH>(dst, g + bh * seq_elems, row0, seq, d, bar, lane);
      }
    };
    int qn[NWG];
#pragma unroll
    for (int w = 0; w < NWG; ++w) qn[w] = 0;
    uint32_t t = 0;
    for (int bh = blockIdx.x; bh < n_bh; bh += gridDim.x) {
      for (int round = 0; round < rounds; ++round) {
#pragma unroll
        for (int w = 0; w < NWG; ++w) {
          const int qt = round * NWG + w;
          if (qt >= n_tiles) continue;
          const int slot = qn[w] & 1;
          mbar_wait(&q_empty[w][slot], ((qn[w] >> 1) & 1) ^ 1);
          load(&map_q, q, q_tiles + (w * 2 + slot) * NH * TILE_BYTES, &q_full[w][slot], bh,
               qt * TILE);
          ++qn[w];
        }
        for (int kt = 0; kt < n_tiles; ++kt, ++t) {
          const int stage = t % NST;
          mbar_wait(&kv_empty[stage], ((t / NST) & 1) ^ 1);
          load(&map_k, k, k_tiles + stage * NH * TILE_BYTES, &k_full[stage], bh, kt * TILE);
          load(&map_v, v, v_tiles + stage * NH * TILE_BYTES, &v_full[stage], bh, kt * TILE);
        }
      }
    }
  } else if (warp < NWG * 4) {
    // ---- consumer warpgroup wg: q tile round * NWG + wg of each round
    const int wg = warp / 4;
    const int row_in_tile = (warp % 4) * 16 + lane / 4;  // rows row_in_tile and +8
    const int col_in_8 = 2 * (lane % 4);                 // columns col_in_8 + {0, 1} of each 8
    uint32_t t = 0;
    int qn = 0;
    for (int bh = blockIdx.x; bh < n_bh; bh += gridDim.x) {
      for (int round = 0; round < rounds; ++round) {
        const int qt = round * NWG + wg;
        const bool active = qt < n_tiles;
        const int slot = qn & 1;
        const uint8_t* q_tile = q_tiles + (wg * 2 + slot) * NH * TILE_BYTES;
        if (active) mbar_wait(&q_full[wg][slot], (qn >> 1) & 1);

        float o[NH][32];
        float m[2] = {MASK, MASK}, l[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[h][i] = 0.f;

        for (int kt = 0; kt < n_tiles; ++kt, ++t) {
          const int stage = t % NST;
          const uint32_t parity = (t / NST) & 1;
          const uint8_t* k_tile = k_tiles + stage * NH * TILE_BYTES;
          const uint8_t* v_tile = v_tiles + stage * NH * TILE_BYTES;
          uint32_t p[16];
          mbar_wait(&k_full[stage], parity);
          if (active) {
            float s[32];
            fence_regs(s);
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)  // 16 head columns (32 bytes) a step
                wgmma_ss(s, smem_desc(q_tile + h * TILE_BYTES) + 2 * kk,
                         smem_desc(k_tile + h * TILE_BYTES) + 2 * kk, h + kk > 0);
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(s);
            if (kt == n_tiles - 1) mbar_arrive(&q_empty[wg][slot]);

            // online softmax in the log2 domain; s[4j + 2i + e] is row
            // row_in_tile + 8i, key 8j + col_in_8 + e of this tile
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float mx = MASK;
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int key = kt * TILE + 8 * j + col_in_8 + e;
                  float& x = s[4 * j + 2 * i + e];
                  x = key < seq ? x * scale_log2 : MASK;
                  mx = fmaxf(mx, x);
                }
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
              const float m_new = fmaxf(m[i], mx);
              const float corr = exp2f(m[i] - m_new);
              m[i] = m_new;
              float sum = 0.f;
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  float& x = s[4 * j + 2 * i + e];
                  x = exp2f(x - m_new);
                  sum += x;
                }
              l[i] = l[i] * corr + sum;  // this lane's share; reduced at the end
#pragma unroll
              for (int h = 0; h < NH; ++h)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  o[h][4 * j + 2 * i] *= corr;
                  o[h][4 * j + 2 * i + 1] *= corr;
                }
            }
            // P as the A fragment of m64n64k16, keys 16 kk .. 16 kk + 15
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              p[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
              p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
              p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
              p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
            }
          }
          mbar_wait(&v_full[stage], parity);
          if (active) {
#pragma unroll
            for (int h = 0; h < NH; ++h) fence_regs(o[h]);
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)  // 16 keys (2048 bytes) a step
                wgmma_rs(o[h], p + 4 * kk, smem_desc(v_tile + h * TILE_BYTES) + 128 * kk);
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int h = 0; h < NH; ++h) fence_regs(o[h]);
          }
          mbar_arrive(&kv_empty[stage]);
        }

        if (active) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float li = l[i];
            li += __shfl_xor_sync(0xffffffffu, li, 1);
            li += __shfl_xor_sync(0xffffffffu, li, 2);
            const int row = qt * TILE + row_in_tile + 8 * i;
            if (row >= seq) continue;
            const float inv = 1.f / li;
            bf16* orow = out + bh * seq_elems + (size_t)row * d;
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = 64 * h + 8 * j + col_in_8;
                if (col < d)
                  *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                      o[h][4 * j + 2 * i] * inv, o[h][4 * j + 2 * i + 1] * inv);
              }
            if (lane % 4 == 0) lse[(size_t)bh * seq + row] = (m[i] + log2f(li)) * LN2;
          }
          ++qn;
        }
      }
    }
  }
}

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

// 3-D map over (BH, S, D), innermost first, box (64 columns, 64 rows, 1 bh)
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

template <int NH, int NWG, int NST>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse, int bh,
                   int seq, int d, float scale, bool persistent, cudaStream_t stream) {
  CUtensorMap maps[3] = {};
  const bool use_tma = d % 8 == 0;  // TMA needs 16-byte row strides
  if (use_tma && !(make_map(&maps[0], q, bh, seq, d) && make_map(&maps[1], k, bh, seq, d) &&
                   make_map(&maps[2], v, bh, seq, d)))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_bf16_kernel<NH, NWG, NST>;
  const int bytes = Smem<NH, NWG, NST>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int grid = bh;
  if (persistent) {
    int sms = 0;
    if ((err = sm_count(&sms)) != cudaSuccess) return err;
    grid = bh < sms ? bh : sms;
  }
  kernel<<<grid, NWG * 128 + 32, bytes, stream>>>(maps[0], maps[1], maps[2], q, k, v, out, lse,
                                                  bh, seq, d, scale * LOG2E, use_tma ? 1 : 0);
  return cudaGetLastError();
}

// one 64-column tile of the head up to D = 64, two above (NST128 stages)
template <int NWG, int NST64, int NST128>
int dispatch(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int seq,
             int d, float scale, bool persistent, void* stream) {
  if (bh <= 0 || seq <= 0 || d <= 0 || d > 128 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qb = static_cast<const bf16*>(q), kb = static_cast<const bf16*>(k),
       vb = static_cast<const bf16*>(v);
  auto ob = static_cast<bf16*>(out);
  auto lf = static_cast<float*>(lse);
  if (d <= 64)
    return (int)launch<1, NWG, NST64>(qb, kb, vb, ob, lf, bh, seq, d, scale, persistent, s);
  return (int)launch<2, NWG, NST128>(qb, kb, vb, ob, lf, bh, seq, d, scale, persistent, s);
}

}  // namespace

// C entry points, bound with ctypes: bfloat16 q, k, v (BH, S, D) contiguous
// and 16-byte aligned, out (BH, S, D) bfloat16, lse (BH, S) float32. Each
// returns the cudaError_t of the launch (0 on success).

// The served kernel: a ring of stages, three consumer warpgroups,
// persistent blocks.
extern "C" int gordo_flash_fwd_bf16(const void* q, const void* k, const void* v, void* out,
                                    void* lse, int bh, int seq, int d, float scale, void* stream) {
  return dispatch<3, 6, 2>(q, k, v, out, lse, bh, seq, d, scale, true, stream);
}

// The first build-up step, kept as a check of the products alone: one
// consumer warpgroup, one stage, one bh per block.
extern "C" int gordo_flash_fwd_bf16_single_stage(const void* q, const void* k, const void* v,
                                                 void* out, void* lse, int bh, int seq, int d,
                                                 float scale, void* stream) {
  return dispatch<1, 1, 1>(q, k, v, out, lse, bh, seq, d, scale, false, stream);
}

extern "C" const char* gordo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
