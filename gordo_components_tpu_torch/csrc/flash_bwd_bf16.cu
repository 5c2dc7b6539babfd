// Non-causal attention backward in bfloat16 on Hopper's tensor cores.
//
// Replaces `_bwd_3d` in gordo_components_tpu/ops/flash_attention.py
// (:187-229), the backward half of the `jax.custom_vjp` rules (:232-273)
// around the Pallas kernel `_fwd_kernel` (pl.pallas_call at :157). Same
// contract as flash_bwd_f32.cu, in bfloat16: q, k, v, out, dout (BH, S, D)
// bfloat16, lse and the optional dlse (BH, S) float32; dq, dk, dv (BH, S, D)
// bfloat16. The arithmetic is float32 accumulation, as in `_bwd_3d`; P and
// dS are rounded to bfloat16 before the products that take them, as the
// forward rounds P (2^-9 relative on each term). Keys and rows at or
// beyond S contribute nothing. S is any length >= 1, D any multiple of 4
// up to 128.
//
// The recurrence (see flash_bwd_f32.cu): P = exp(Q K^T scale - lse),
// dV = P^T dO, dP = dO V^T, dS = P o (dP - delta) scale with delta =
// rowsum(dO o O) - dlse, dQ = dS K, dK = dS^T Q.
//
// What bounds it on an H100: at the training shape (16384, 179, 64) one
// call reads q, k, v, out, dout (5 x 0.375 GB) and lse, and writes dq,
// dk, dv (3 x 0.375 GB): 3.0 GB, 0.90 ms at 3.35 TB/s, while its five
// products (336 GFLOP) take 0.34 ms at 989 TFLOP/s. The bound is bytes:
// the design reads every operand once and keeps everything else on chip.
//
// What the design does about it: one launch, one block owning whole
// sequences, five products, no atomics.
// - Persistent blocks, one per SM, walk over bh. One producer warp issues
//   TMA loads (the forward's 3-D map over (BH, S, D), box (1, 64, 64),
//   128-byte swizzle, zero fill past S and D) into a ring of q-tile stages
//   (Q, dO and O of 64 rows each) and a double buffer of key tiles (K and
//   V of 64 keys per consumer warpgroup), so the next tiles and the next
//   sequence are in flight while this one computes. A head_dim that is not
//   a multiple of 8 breaks TMA's 16-byte stride rule: the producer then
//   copies the same swizzled tiles with plain loads.
// - Three consumer warpgroups own one 64-key tile each (S = 179 is three)
//   and keep its dK and dV in fp32 registers while they walk the q tiles.
//   Per q tile, each computes delta and lse of its 64 rows from the
//   shared-memory tiles (no separate delta pass), then S^T = K Q^T and
//   dP^T = V dO^T (wgmma.m64n64k16, both operands K-major in shared memory,
//   fp32 accumulators): P^T and dS^T are then in the accumulator registers
//   in the layout of a register-A operand. Rounded to bf16, they are the A
//   operands of dV += P^T dO and dK += dS^T Q, with dO and Q the B operands
//   read MN-major (the transpose bit, as V in the forward). dS^T also goes
//   to a shared tile; once every warpgroup's tile is there (an mbarrier),
//   one warpgroup (q tile t goes to warpgroup t mod 3) computes dQ = dS K
//   over every key tile of the block, with dS^T and K both read MN-major,
//   accumulated in its registers in key order, and writes it once. The dS
//   tiles are double buffered and released by an mbarrier, so the other
//   warpgroups go on to the next q tile while dQ is formed. So S and dP
//   are computed once, each operand is read once, and the sum is in a fixed
//   order: bit-identical from run to run.
// - Sequences longer than three key tiles are walked in rounds of three
//   key tiles. dQ of the earlier rounds goes to an fp32 scratch row block
//   that the block alone owns (workspace: one (S, D) matrix per block),
//   added in round order by the warpgroup that owns the q tile; the last
//   round writes dQ. D up to 128 takes two 64-column halves and two
//   consumer warpgroups (the registers of dK, dV and dQ double).
//
// Shared memory at D <= 64 (<NH 1, NWG 3, NKV 2, NQS 3>): key tiles
// 2 x 3 x 2 x 8,192 = 98,304 B, q stages 3 x 3 x 8,192 = 73,728 B, dS tiles
// 2 x 3 x 8,192 = 49,152 B, 1,024 B of alignment slack, and 1,536 B static
// (lse and delta): 223,744 of 232,448 B. At D <= 128 (<2, 2, 1, 2>):
// 65,536 + 98,304 + 32,768 + 1,024 + 1,024 = 198,656 B.
//
// Registers: 512 threads a block, the consumer warpgroups and a producer
// warpgroup (one warp of it issues the copies). setmaxnreg leaves the
// producer 24 registers and gives each consumer thread 160 (240 at
// D > 64): dK, dV and one transient accumulator (S^T, then dP^T, then
// dQ) are 96 of them. With fewer, or with lane-derived addresses hoisted
// out of the q-tile loop, ptxas spills inside the loop and serializes the
// wgmma (every product waited for alone): 1.93 ms against 1.60 at the
// training shape (PERF.md, PR 7). The warp index goes through a shuffle,
// so that ptxas sees each warpgroup's branches as uniform.
//
// Resources (nvcc 12.8, -Xptxas -v, sm_90a; tools/flash_kernel_sweep.py):
// <1, 3, 2, 3> 84 bytes spilled, <2, 2, 1, 2> 72; no wgmma serialized. The
// sweep builds libraries of its own with -DFLASH_BWD_BF16_QSTAGES=2; the
// served library takes 3.

#include <math.h>

#include "hopper.cuh"

namespace {

// 2^x on the MUFU unit (relative error ~2^-22); x <= 0 here
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// registers a thread of this warpgroup may hold from here on: the producer
// warpgroup gives up all but PRODUCER_REGS, the consumers take what it left
template <bool INC, int REGS>
__device__ __forceinline__ void set_max_registers() {
  if (INC)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
constexpr int PRODUCER_REGS = 24;

// x, through an instruction the compiler may not move out of a loop
__device__ __forceinline__ int opaque(int x) {
  int y;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// NH: 64-column halves of the head; NWG: consumer warpgroups (key tiles of
// a round); NKV: key-tile buffers; NQS: q-tile stages.
template <int NH, int NWG, int NKV, int NQS>
struct Layout {
  static constexpr int T = NH * TILE_BYTES;              // one operand's tile, all halves
  static constexpr int KV_BYTES = NKV * NWG * 2 * T;     // [NKV][NWG][K, V]
  static constexpr int Q_BYTES = NQS * 3 * T;            // [NQS][Q, dO, O]
  static constexpr int DS_BYTES = 2 * NWG * TILE_BYTES;  // [2][NWG] dS^T tiles
  static constexpr int BYTES = KV_BYTES + Q_BYTES + DS_BYTES + 1024;  // + alignment slack
  // the register file (65,536) less the producer warpgroup's, over the
  // consumers, rounded down to a multiple of 8
  static constexpr int CONSUMER_REGS = (65536 / 128 - PRODUCER_REGS) / NWG / 8 * 8;
};

template <int NH, int NWG, int NKV, int NQS>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
    flash_bwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_o,
                          const __grid_constant__ CUtensorMap map_do, const bf16* __restrict__ q,
                          const bf16* __restrict__ k, const bf16* __restrict__ v,
                          const bf16* __restrict__ out, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dlse,
                          bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ dq_scratch, int n_bh, int seq, int d, float scale,
                          int use_tma) {
  using L = Layout<NH, NWG, NKV, NQS>;
  constexpr int T = L::T;
  __shared__ __align__(8) uint64_t q_full[NQS], q_empty[NQS];
  __shared__ __align__(8) uint64_t kv_full[NKV][NWG], kv_empty[NKV];
  __shared__ __align__(8) uint64_t ds_full[2], ds_empty[2];
  __shared__ float lse_s[NWG][TILE], delta_s[NWG][TILE];  // per warpgroup, lse in log2
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* kv_tiles = base;                 // [NKV][NWG][K, V] tiles
  uint8_t* q_tiles = base + L::KV_BYTES;    // [NQS][Q, dO, O] tiles
  uint8_t* ds_tiles = q_tiles + L::Q_BYTES; // [2][NWG] tiles

  const int n_tiles = (seq + TILE - 1) / TILE;  // q tiles = key tiles
  const int rounds = (n_tiles + NWG - 1) / NWG;
  // the warp index through a shuffle, so that the compiler knows it (and the
  // warpgroup's role and key tile) uniform across the warp
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;
  const size_t seq_elems = (size_t)seq * d;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NQS; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], NWG * 128);
    }
    for (int b = 0; b < NKV; ++b) {
      for (int w = 0; w < NWG; ++w) mbar_init(&kv_full[b][w], 1);
      mbar_init(&kv_empty[b], NWG * 128);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&ds_full[b], NWG * 128);
      mbar_init(&ds_empty[b], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    // ---- producer warpgroup: its first warp issues a round's key tiles,
    // then its q tiles, in order; it hands its registers to the consumers
    set_max_registers<false, PRODUCER_REGS>();
    if (warp != NWG * 4) return;
    auto issue = [&](const CUtensorMap* map, const bf16* g, uint8_t* dst, int bh, int row0,
                     uint64_t* bar) {
      if (use_tma) {
        if (lane == 0) {
#pragma unroll
          for (int h = 0; h < NH; ++h)
            tma_load_3d(dst + h * TILE_BYTES, map, 64 * h, row0, bh, bar);
        }
      } else {
        plain_copy<NH>(dst, g + bh * seq_elems, row0, seq, d, lane);
      }
    };
    auto expect = [&](uint64_t* bar, int operands) {
      if (use_tma && lane == 0) mbar_expect_tx(bar, operands * T);
    };
    auto release = [&](uint64_t* bar) {
      if (!use_tma) plain_release(bar, lane);
      __syncwarp();
    };
    uint32_t nq = 0, nr = 0;
    for (int bh = blockIdx.x; bh < n_bh; bh += gridDim.x) {
      for (int round = 0; round < rounds; ++round, ++nr) {
        const int kb = nr % NKV;
        mbar_wait(&kv_empty[kb], ((nr / NKV) & 1) ^ 1);
        for (int w = 0; w < NWG; ++w) {
          const int kt = round * NWG + w;
          uint8_t* dst = kv_tiles + (kb * NWG + w) * 2 * T;
          uint64_t* bar = &kv_full[kb][w];
          if (kt >= n_tiles) {
            // no tile past S, but the phase completes all the same: every
            // key-tile barrier completes once a round, so the parity a
            // warpgroup reads off the round count holds in every round
            if (lane == 0) mbar_arrive(bar);
            __syncwarp();
            continue;
          }
          expect(bar, 2);
          issue(&map_k, k, dst, bh, kt * TILE, bar);
          issue(&map_v, v, dst + T, bh, kt * TILE, bar);
          release(bar);
        }
        for (int qt = 0; qt < n_tiles; ++qt, ++nq) {
          const int slot = nq % NQS;
          mbar_wait(&q_empty[slot], ((nq / NQS) & 1) ^ 1);
          uint8_t* dst = q_tiles + slot * 3 * T;
          uint64_t* bar = &q_full[slot];
          expect(bar, 3);
          issue(&map_q, q, dst, bh, qt * TILE, bar);
          issue(&map_do, dout, dst + T, bh, qt * TILE, bar);
          issue(&map_o, out, dst + 2 * T, bh, qt * TILE, bar);
          release(bar);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: key tile round * NWG + wg of each round
    set_max_registers<true, Layout<NH, NWG, NKV, NQS>::CONSUMER_REGS>();
    const int wg = warp / 4, t = threadIdx.x % 128;
    const int row_in_tile = (warp % 4) * 16 + lane / 4;  // rows row_in_tile and +8
    const int col_in_8 = 2 * (lane % 4);                 // columns col_in_8 + {0, 1} of each 8
    const float scale_log2 = scale * LOG2E;
    float* scratch = dq_scratch + (size_t)blockIdx.x * seq_elems;
    uint32_t nq = 0, nr = 0;
    for (int bh = blockIdx.x; bh < n_bh; bh += gridDim.x) {
      for (int round = 0; round < rounds; ++round, ++nr) {
        const int kb = nr % NKV;
        const uint32_t kv_parity = (nr / NKV) & 1;
        const int kt = round * NWG + wg;
        const bool active = kt < n_tiles;
        const int live_tiles = min(NWG, n_tiles - round * NWG);
        const int kv_off = (kb * NWG + wg) * 2 * T;
        if (active) mbar_wait(&kv_full[kb][wg], kv_parity);

        float acc_k[NH][32], acc_v[NH][32];
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc_k[h][i] = acc_v[h][i] = 0.f;

        for (int qt = 0; qt < n_tiles; ++qt, ++nq) {
          const int slot = nq % NQS;
          const uint8_t* q_tile = q_tiles + slot * 3 * T;
          const uint8_t* do_tile = q_tile + T;
          const uint8_t* o_tile = q_tile + 2 * T;
          uint8_t* ds_buf = ds_tiles + (nq & 1) * NWG * TILE_BYTES;
          mbar_wait(&q_full[slot], (nq / NQS) & 1);
          // the lane's rows, columns and tile addresses are read anew where they
          // are used: hoisted, they would hold registers the products need
          const int tt = opaque(t);
          // the transient accumulators: S^T, then dP^T, then (one warpgroup) dQ
          float work[NH][32];
          const uint8_t* k_tile = kv_tiles + opaque(kv_off);
          const uint8_t* v_tile = k_tile + T;

          // delta and lse of the tile's 64 rows: two threads per row
          {
            const int r = tt / 2, half = tt % 2;
            float sum = 0.f;
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int off = h * TILE_BYTES + r * 128 + (((half * 4 + i) ^ (r % 8)) << 4);
                const uint4 a = *reinterpret_cast<const uint4*>(do_tile + off);
                const uint4 b = *reinterpret_cast<const uint4*>(o_tile + off);
                const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
                const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(b2[e]);
                  sum = fmaf(x.x, y.x, sum);
                  sum = fmaf(x.y, y.y, sum);
                }
              }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            if (half == 0) {
              const int row = qt * TILE + r;
              const bool live = row < seq;
              const size_t at = (size_t)bh * seq + row;
              delta_s[wg][r] = live ? sum - (dlse != nullptr ? dlse[at] : 0.f) : 0.f;
              lse_s[wg][r] = live ? lse[at] * LOG2E : 0.f;
            }
          }
          named_barrier(2 + wg, 128);
          // the dS^T buffer's last dQ is formed (every warpgroup waits, so
          // none arrives on ds_full for a later use before this one's phase)
          mbar_wait(&ds_empty[nq & 1], ((nq >> 1) & 1) ^ 1);

          if (active) {
            // S^T = K Q^T; element [4 j + 2 i + e] is key row_in_tile + 8 i,
            // q row 8 j + col_in_8 + e of the tile
            float(&s)[32] = work[0];
            fence_regs(s);
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)  // 16 head columns (32 bytes) a step
                wgmma_ss(s, smem_desc(k_tile + h * TILE_BYTES) + 2 * kk,
                         smem_desc(q_tile + h * TILE_BYTES) + 2 * kk, h + kk > 0);
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(s);

            // P^T, rounded to bf16, as the A fragments of m64n64k16 (q rows
            // 16 kk .. 16 kk + 15): pa[4 kk + x] holds elements 8 kk + 2 x, + 1
            const int rp = opaque(row_in_tile), cp = opaque(col_in_8);
            uint32_t pa[16];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                float p2[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int idx = 8 * kk + 2 * x + e;
                  const int i = x % 2, col = 16 * kk + 8 * (x / 2) + cp + e;
                  const bool live =
                      kt * TILE + rp + 8 * i < seq && qt * TILE + col < seq;
                  p2[e] = live ? fast_exp2(s[idx] * scale_log2 - lse_s[wg][col]) : 0.f;
                }
                pa[4 * kk + x] = pack_bf16(p2[0], p2[1]);
              }

            // dP^T = V dO^T, and dV += P^T dO (16 q rows, 2048 bytes, a step)
            float(&dp)[32] = work[0];
            fence_regs(dp);
#pragma unroll
            for (int h = 0; h < NH; ++h) fence_regs(acc_v[h]);
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_ss(dp, smem_desc(v_tile + h * TILE_BYTES) + 2 * kk,
                         smem_desc(do_tile + h * TILE_BYTES) + 2 * kk, h + kk > 0);
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_rs(acc_v[h], pa + 4 * kk, smem_desc(do_tile + h * TILE_BYTES) + 128 * kk);
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(dp);
#pragma unroll
            for (int h = 0; h < NH; ++h) fence_regs(acc_v[h]);

            // dS^T = P^T o (dP^T - delta) scale, from the bf16 P^T that dV
            // took; as A fragments, and into this warpgroup's shared tile,
            // [key][q] swizzled, for dQ
            const int rs = opaque(row_in_tile), cs = opaque(col_in_8);
            uint32_t dsa[16];
            uint8_t* ds_tile = ds_buf + wg * TILE_BYTES;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const float2 p2 =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pa[4 * kk + x]));
                const int i = x % 2, col = 16 * kk + 8 * (x / 2) + cs;
                const float delta0 = delta_s[wg][col], delta1 = delta_s[wg][col + 1];
                dsa[4 * kk + x] = pack_bf16(p2.x * (dp[8 * kk + 2 * x] - delta0) * scale,
                                            p2.y * (dp[8 * kk + 2 * x + 1] - delta1) * scale);
                *reinterpret_cast<uint32_t*>(ds_tile + swizzled(rs + 8 * i, col)) =
                    dsa[4 * kk + x];
              }
            // the tile is read by wgmma through the async proxy
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(&ds_full[nq & 1]);

            // dK += dS^T Q
#pragma unroll
            for (int h = 0; h < NH; ++h) fence_regs(acc_k[h]);
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_rs(acc_k[h], dsa + 4 * kk, smem_desc(q_tile + h * TILE_BYTES) + 128 * kk);
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int h = 0; h < NH; ++h) fence_regs(acc_k[h]);
          } else {
            mbar_arrive(&ds_full[nq & 1]);  // no dS^T tile of this warpgroup
          }
          mbar_arrive(&q_empty[slot]);  // Q, dO and O no longer read by this thread

          if (qt % NWG == wg) {
            // dQ = dS K over the round's key tiles, in key order
            float(&acc_q)[NH][32] = work;
#pragma unroll
            for (int h = 0; h < NH; ++h) fence_regs(acc_q[h]);
            for (int w = 0; w < live_tiles; ++w) mbar_wait(&kv_full[kb][w], kv_parity);
            mbar_wait(&ds_full[nq & 1], (nq >> 1) & 1);  // every dS^T tile is written
            wgmma_fence();
            for (int w = 0; w < live_tiles; ++w) {
              const uint8_t* kw = kv_tiles + opaque((kb * NWG + w) * 2 * T);
              const uint8_t* dsw = ds_buf + w * TILE_BYTES;
#pragma unroll
              for (int h = 0; h < NH; ++h)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)  // 16 keys (2048 bytes) a step
                  wgmma_ss_mn(acc_q[h], smem_desc(dsw) + 128 * kk,
                              smem_desc(kw + h * TILE_BYTES) + 128 * kk, w + kk > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int h = 0; h < NH; ++h) fence_regs(acc_q[h]);
            mbar_arrive(&ds_empty[nq & 1]);  // the dS^T tiles may be rewritten

            const bool first = round == 0, last = round == rounds - 1;
            const int re = opaque(row_in_tile), ce = opaque(col_in_8);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int row = qt * TILE + re + 8 * i;
              if (row >= seq) continue;
#pragma unroll
              for (int h = 0; h < NH; ++h)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  const int col = 64 * h + 8 * j + ce;
                  if (col >= d) continue;
                  float2 x = make_float2(acc_q[h][4 * j + 2 * i], acc_q[h][4 * j + 2 * i + 1]);
                  float2* cell = reinterpret_cast<float2*>(scratch + (size_t)row * d + col);
                  if (!first) {
                    const float2 y = *cell;
                    x.x += y.x;
                    x.y += y.y;
                  }
                  if (last)
                    *reinterpret_cast<__nv_bfloat162*>(dq + bh * seq_elems + (size_t)row * d +
                                                       col) = __floats2bfloat162_rn(x.x, x.y);
                  else
                    *cell = x;
                }
            }
          }
        }

        // dK and dV of this warpgroup's key tile, written once
        if (active) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int key = kt * TILE + row_in_tile + 8 * i;
            if (key >= seq) continue;
            const size_t row_at = bh * seq_elems + (size_t)key * d;
#pragma unroll
            for (int h = 0; h < NH; ++h)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = 64 * h + 8 * j + col_in_8;
                if (col >= d) continue;
                *reinterpret_cast<__nv_bfloat162*>(dk + row_at + col) =
                    __floats2bfloat162_rn(acc_k[h][4 * j + 2 * i], acc_k[h][4 * j + 2 * i + 1]);
                *reinterpret_cast<__nv_bfloat162*>(dv + row_at + col) =
                    __floats2bfloat162_rn(acc_v[h][4 * j + 2 * i], acc_v[h][4 * j + 2 * i + 1]);
              }
          }
        }
        mbar_arrive(&kv_empty[kb]);  // every key tile of the round no longer read
      }
    }
  }
}

template <int NH, int NWG>
long long workspace_bytes(int bh, int seq, int d, int sms) {
  const int n_tiles = (seq + TILE - 1) / TILE;
  if (n_tiles <= NWG) return 0;  // one round: dQ is written from the registers
  const long long grid = bh < sms ? bh : sms;
  return grid * seq * d * (long long)sizeof(float);
}

template <int NH, int NWG, int NKV, int NQS>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
                   const bf16* dout, const float* lse, const float* dlse, bf16* dq, bf16* dk,
                   bf16* dv, float* workspace, int bh, int seq, int d, float scale,
                   cudaStream_t stream) {
  CUtensorMap maps[5] = {};
  const bool use_tma = d % 8 == 0;  // TMA needs 16-byte row strides
  if (use_tma && !(make_map(&maps[0], q, bh, seq, d) && make_map(&maps[1], k, bh, seq, d) &&
                   make_map(&maps[2], v, bh, seq, d) && make_map(&maps[3], out, bh, seq, d) &&
                   make_map(&maps[4], dout, bh, seq, d)))
    return cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (workspace == nullptr && workspace_bytes<NH, NWG>(bh, seq, d, sms) > 0)
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_bf16_kernel<NH, NWG, NKV, NQS>;
  const int bytes = Layout<NH, NWG, NKV, NQS>::BYTES;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
      cudaSuccess)
    return err;
  const int grid = bh < sms ? bh : sms;
  kernel<<<grid, (NWG + 1) * 128, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], q,
                                                  k, v, out, dout, lse, dlse, dq, dk, dv,
                                                  workspace, bh, seq, d, scale, use_tma ? 1 : 0);
  return cudaGetLastError();
}

// the instantiations: one 64-column tile of the head and three consumer
// warpgroups up to D = 64; two halves and two warpgroups up to 128
constexpr int NWG64 = 3, NWG128 = 2;
#ifndef FLASH_BWD_BF16_QSTAGES
#define FLASH_BWD_BF16_QSTAGES 3  // q-tile stages at D <= 64: 2 or 3
#endif

}  // namespace

// C entry points, bound with ctypes: bfloat16 q, k, v, out, dout (BH, S, D)
// contiguous and 16-byte aligned, lse (BH, S) float32, dlse (BH, S) float32
// or null; dq, dk, dv (BH, S, D) bfloat16; workspace float32 scratch of
// gordo_flash_bwd_bf16_workspace(bh, seq, d) bytes (null when that is 0).
// Returns the cudaError_t of the launch (0 on success); the caller raises.
extern "C" long long gordo_flash_bwd_bf16_workspace(int bh, int seq, int d) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return d <= 64 ? workspace_bytes<1, NWG64>(bh, seq, d, sms)
                 : workspace_bytes<2, NWG128>(bh, seq, d, sms);
}

extern "C" int gordo_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                                    const void* dout, const void* lse, const void* dlse, void* dq,
                                    void* dk, void* dv, void* workspace, int bh, int seq, int d,
                                    float scale, void* stream) {
  if (bh <= 0 || seq <= 0 || d <= 0 || d > 128 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  auto dqb = static_cast<bf16*>(dq), dkb = static_cast<bf16*>(dk), dvb = static_cast<bf16*>(dv);
  auto ws = static_cast<float*>(workspace);
  if (d <= 64)
    return (int)launch<1, NWG64, 2, FLASH_BWD_BF16_QSTAGES>(
        b(q), b(k), b(v), b(out), b(dout), f(lse), f(dlse), dqb, dkb, dvb, ws, bh, seq, d, scale,
        s);
  return (int)launch<2, NWG128, 1, 2>(b(q), b(k), b(v), b(out), b(dout), f(lse), f(dlse), dqb,
                                      dkb, dvb, ws, bh, seq, d, scale, s);
}

extern "C" const char* gordo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
