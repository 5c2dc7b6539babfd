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
// - The mbarrier, TMA, swizzle and wgmma helpers live in hopper.cuh, which
//   the bf16 backward (flash_bwd_bf16.cu) shares.
//
// Resources (nvcc 12.8, -Xptxas -v, sm_90a; tools/flash_kernel_sweep.py):
// the served <NH = 1, NWG = 3, NST = 6> runs 416 threads at 106 registers
// with no spills, 240 bytes of static and 148,480 bytes of dynamic shared
// memory: one block per SM. <2, 3, 2> (D > 64): 128 registers, 48 bytes
// spilled. Measured at the slice shape (NVIDIA H100 80GB HBM3, 700 W):
// 0.34 ms, 2.25 TB/s, 67 % of the bytes bound (PERF.md, PR 2).

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float MASK = -1e30f;

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
