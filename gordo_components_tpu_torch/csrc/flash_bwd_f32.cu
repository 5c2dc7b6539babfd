// Non-causal attention backward in float32 on CUDA cores, for Hopper.
//
// Replaces `_bwd_3d` in gordo_components_tpu/ops/flash_attention.py
// (:187-229), the backward half of the `jax.custom_vjp` rules (:232-273)
// around the Pallas kernel `_fwd_kernel` (pl.pallas_call at :157), which
// serve both `_flash_3d` (flash_attention) and `flash_block_with_lse`.
// Same contract: from the forward's saved q, k, v, out (BH, S, D) and lse
// (BH, S), the output cotangent dout (BH, S, D) and an optional lse
// cotangent dlse (BH, S), it gives dq, dk, dv (BH, S, D), all float32 (the
// bf16 entry is flash_bwd_bf16.cu). Keys and rows at or beyond S contribute
// nothing. S is any length >= 1, D any multiple of 4 up to 128.
//
// The recurrence (P is recomputed from the saved lse, never stored):
//   P    = exp(Q K^T * scale - lse)         (rows i, keys j)
//   dV   = P^T dO
//   dP   = dO V^T
//   dS   = P o (dP - delta_i) * scale,   delta_i = rowsum(dO o O) - dlse_i
//   dQ   = dS K,   dK = dS^T Q
// (dlse enters as `dresid += dlse` in the reference: d lse_i / d s_ij =
// p_ij, and it never touches dV.)
//
// What bounds it on an H100: five S x S x D products, 10*BH*S^2*D
// operations, at 67 TFLOP/s of fp32 outside the tensor cores; at the
// training shape (16384, 179, 64) that is 5.0 ms, against 1.8 ms to move
// q, k, v, out, dout, lse once and write dq, dk, dv once at 3.35 TB/s: the
// bound is operations. Every product is an exact fp32 FFMA (no TF32, which
// cannot meet 2e-5 of the largest grad); exp is MUFU ex2.approx.
//
// What the design does about it: one launch, one block owning whole
// sequences, five products, no atomics.
// - Persistent blocks (one per SM: the shared memory below) walk over bh.
//   A block loads the sequence's q and dO rows once into shared memory
//   (cp.async with zero fill past S and D), computes delta and lse for
//   them there (no separate delta pass; out is read once, into
//   registers), and walks the keys in 64-key tiles, the next tile's K and
//   V in flight (a second buffer) while this one is used. Per key tile it
//   keeps dK and dV in registers while it walks the 64-row q tiles: per
//   (q tile, key tile) it computes S and dP once (two products), P and dS,
//   then dV += P^T dO, dK += dS^T Q and dQ += dS K (three products). dQ of
//   the resident rows stays in registers, summed key tile after key tile,
//   in order: no atomics, a bit-identical result from run to run. dQ is
//   written once at the end, dK and dV once per key tile. On the last key
//   tile each finished q tile's rows are refilled with the next
//   sequence's, so its loads overlap this one's products.
// - Longer sequences (S > 192 at D <= 64, S > 64 at D > 64) walk the q
//   rows in chunks of that length. dQ of a chunk is complete when its key
//   walk ends; dK and dV of the later chunks are added to the float32
//   outputs the block itself wrote for the earlier ones, in chunk order.
// - 256 threads in two groups of four warps. Group 0 computes S, P and
//   dV, group 1 dP, dS and dK, each thread a 4 x 8 register tile (the
//   forward's): for S or dP, q rows gy + 16 i and keys gx + 8 j, loading
//   16-byte float4 along D, 12 loads per 128 FFMA; for dV or dK, keys
//   4 gy .. + 3 and columns 4 gx + 32 h, one float4 of P (dS) and two of
//   dO (Q) per q row for 32 FFMA. A warp's loads touch 4 rows of the
//   row-indexed operand and 8 of the other (row stride D + 4: distinct
//   banks). dS = P (dP - delta) scale is formed by group 1 from group 0's
//   P in shared memory. dQ: all 256 threads as a 16 x 16 grid, rows
//   ty + 16 i, columns 4 tx (+ 64 h), float4 of dS and K per 4 keys. P and
//   dS have row stride 72 floats: a warp's scalar stores to 4 rows x 8
//   keys fall in 32 banks. 64-key tiles pad S = 179 to 192 keys (7 %);
//   128-key tiles would pad it to 256 (43 %).
//
// Shared memory at D <= 64 (tiles padded to 64 columns, row stride 68):
// q and dO of 192 rows 2 x 52,224 B, K and V of two key tiles 4 x 17,408 B,
// P and dS 2 x 18,432 B, lse and delta 1,536 B: 212,480 of 232,448 B. At
// D <= 128 (stride 132, 64 resident rows, one key-tile buffer):
// 2 x 33,792 + 2 x 33,792 + 2 x 18,432 + 512 = 172,544 B.
//
// Resources (nvcc 12.8, -Xptxas -v, sm_90a; tools/flash_kernel_sweep.py):
// <64> 255 registers, 12 bytes spilled; <128> 254 registers, no spills;
// 256 threads, one block per SM. The sweep builds libraries of its own
// with other -DFLASH_BWD_F32_ROWS; the served library takes 192.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;        // rows (q) or keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PST = BT + 8;   // row stride of the P and dS tiles, in floats
constexpr float LOG2E = 1.4426950408889634f;

#ifndef FLASH_BWD_F32_ROWS
#define FLASH_BWD_F32_ROWS 192  // q rows resident per chunk at D <= 64: 64, 128, 192
#endif

template <int DP>
struct Cfg {
  static constexpr int ST = DP + 4;                              // q, dO, K, V row stride
  static constexpr int QC = DP <= 64 ? FLASH_BWD_F32_ROWS : 64;  // q rows resident per chunk
  static constexpr int NQT = QC / BT;                            // q tiles of a chunk
  static constexpr int NH = DP / 64;                             // 64-column groups of a row
  static constexpr int NKV = DP <= 64 ? 2 : 1;                   // key-tile buffers
  static constexpr size_t BYTES =
      sizeof(float) * (2 * (size_t)QC * ST + NKV * 2 * BT * ST + 2 * BT * PST + 2 * QC);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = live ? 16 : 0;  // 0: nothing read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// 2^x on the MUFU unit (relative error ~2^-22); x <= 0 here
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + rows) of one (S, d) matrix into a [rows][DP + 4] tile,
// zero at or past S and at or past d
template <int DP>
__device__ __forceinline__ void load_rows(float* tile, const float* seq_base, int r0, int rows,
                                          int seq, int d) {
  constexpr int C4 = DP / 4, ST = Cfg<DP>::ST;
  for (int i = threadIdx.x; i < rows * C4; i += THREADS) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool live = r0 + r < seq && c < d;
    cp_async16(tile + r * ST + c, live ? seq_base + (size_t)(r0 + r) * d + c : seq_base, live);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float at(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ out,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dlse, float* __restrict__ dq,
                         float* __restrict__ dk, float* __restrict__ dv, int n_bh, int seq, int d,
                         float scale) {
  using C = Cfg<DP>;
  constexpr int ST = C::ST, QC = C::QC, NH = C::NH, NQT = C::NQT, NKV = C::NKV;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [QC][ST]
  float* dOs = Qs + QC * ST;           // [QC][ST]
  float* KVs = dOs + QC * ST;          // [NKV][K, V][BT][ST]
  float* Ps = KVs + NKV * 2 * BT * ST; // [BT][PST]
  float* dSs = Ps + BT * PST;          // [BT][PST]
  float* lse_s = dSs + BT * PST;       // [QC], log2 domain
  float* delta_s = lse_s + QC;         // [QC]

  // a 16 x 16 grid of threads, each warp a 4 x 8 block of it (warp w at
  // rows 4 (w / 2), columns 8 (w % 2)), so that its loads of a row-indexed
  // operand touch 4 rows and those of a column-indexed one 8 (see the note)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = 4 * (warp / 2) + lane / 8, tx = 8 * (warp % 2) + lane % 8;
  // the two halves of the block: group 0 computes S, P and dV, group 1 dP,
  // dS and dK, each thread a 4 x 8 tile (gy, gx: a 16 x 8 grid per group)
  const int group = warp / 4, gy = 4 * (warp % 4) + lane / 8, gx = lane % 8;
  const int n_kt = (seq + BT - 1) / BT, n_chunks = (seq + QC - 1) / QC;
  const float scale_log2 = scale * LOG2E;
  const size_t seq_elems = (size_t)seq * d;
  auto q_tiles_of = [&](int c0) { return (min(QC, seq - c0) + BT - 1) / BT; };
  auto load_kv = [&](int buf, int bh, int k0) {
    float* dst = KVs + buf * 2 * BT * ST;
    load_rows<DP>(dst, k + bh * seq_elems, k0, BT, seq, d);
    load_rows<DP>(dst + BT * ST, v + bh * seq_elems, k0, BT, seq, d);
  };

  if (blockIdx.x >= n_bh) return;  // uniform over the block
  load_kv(0, blockIdx.x, 0);       // the first work item's first key tile
  int kvb = 0, ready = 0;          // K/V buffer in use; q tiles already loaded

  for (int bh = blockIdx.x; bh < n_bh; bh += gridDim.x) {
    const size_t base = bh * seq_elems;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int c0 = chunk * QC, n_qt = q_tiles_of(c0);
      // the next work item: this sequence's next chunk, or the next sequence
      const bool last_chunk = chunk + 1 == n_chunks;
      const int next_bh = last_chunk ? bh + (int)gridDim.x : bh;
      const int next_c0 = last_chunk ? 0 : c0 + QC;
      const bool has_next = next_bh < n_bh;
      const int next_qt = has_next ? q_tiles_of(next_c0) : 0;

      // q and dO tiles not prefetched during the previous item, and this
      // item's out rows into registers while the copies fly: 16 threads a
      // row, DP / 64 float4 each, 16 rows a pass
      if (ready < n_qt) {
        load_rows<DP>(Qs + ready * BT * ST, q + base, c0 + ready * BT, (n_qt - ready) * BT, seq, d);
        load_rows<DP>(dOs + ready * BT * ST, dout + base, c0 + ready * BT, (n_qt - ready) * BT,
                      seq, d);
      }
      constexpr int PASSES = QC / (THREADS / 16), C4 = DP / 64;
      const int tr = tid / 16, tc = tid % 16;
      float4 ov[PASSES][C4];
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass)
#pragma unroll
        for (int j = 0; j < C4; ++j) {
          const int row = c0 + pass * (THREADS / 16) + tr, col = 4 * (tc + 16 * j);
          ov[pass][j] = row < seq && col < d
                            ? *reinterpret_cast<const float4*>(out + base + (size_t)row * d + col)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      cp_async_wait_all();
      __syncthreads();

      // delta and lse of the resident rows
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        const int r = pass * (THREADS / 16) + tr, row = c0 + r;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < C4; ++j)
          sum = dot4(ov[pass][j],
                     *reinterpret_cast<const float4*>(dOs + r * ST + 4 * (tc + 16 * j)), sum);
#pragma unroll
        for (int off = 8; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (tc == 0) {
          const bool live = row < seq;
          const size_t at_row = (size_t)bh * seq + row;
          delta_s[r] = live ? sum - (dlse != nullptr ? dlse[at_row] : 0.f) : 0.f;
          lse_s[r] = live ? lse[at_row] * LOG2E : 0.f;
        }
      }
      __syncthreads();

      // dQ of the resident rows, in registers: rows qt * 64 + ty + 16 i,
      // columns 4 tx + 64 h
      float acc_q[NQT][4][4 * NH] = {};
      ready = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BT;
        const int k_live = min(BT, seq - k0);
        const bool last_kt = kt + 1 == n_kt;
        const float* Ks = KVs + kvb * 2 * BT * ST;
        const float* Vs = Ks + BT * ST;
        // the next key tile (this item's, or the next item's first) into
        // the other buffer while this one is used
        if (NKV == 2) {
          if (!last_kt) load_kv(kvb ^ 1, bh, k0 + BT);
          else if (has_next) load_kv(kvb ^ 1, next_bh, 0);
        }
        float acc_kv[4][8 * NH] = {};  // dV (group 0) or dK (group 1) of the key tile

#pragma unroll
        for (int qt = 0; qt < NQT; ++qt) {
          if (qt >= n_qt) break;
          const int q_live = min(BT, seq - c0 - qt * BT);
          const float* Qt = Qs + qt * BT * ST;
          const float* dOt = dOs + qt * BT * ST;
          // S (group 0) or dP (group 1): rows gy + 16 i, keys gx + 8 j
          {
            const float* X = group == 0 ? Qt : dOt;
            const float* Y = group == 0 ? Ks : Vs;
            float acc[4][8] = {};
#pragma unroll 4
            for (int c = 0; c < DP; c += 4) {
              float4 xv[4], yv[8];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                xv[i] = *reinterpret_cast<const float4*>(X + (gy + 16 * i) * ST + c);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                yv[j] = *reinterpret_cast<const float4*>(Y + (gx + 8 * j) * ST + c);
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = dot4(xv[i], yv[j], acc[i][j]);
            }
            if (group == 0) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = gy + 16 * i;
                const float l = lse_s[qt * BT + r];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  const int kc = gx + 8 * j;
                  const bool live = r < q_live && kc < k_live;
                  Ps[r * PST + kc] = live ? fast_exp2(acc[i][j] * scale_log2 - l) : 0.f;
                }
              }
            }
            __syncthreads();
            if (group == 1) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = gy + 16 * i;
                const float delta = delta_s[qt * BT + r];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  const int kc = gx + 8 * j;
                  dSs[r * PST + kc] = Ps[r * PST + kc] * (acc[i][j] - delta) * scale;
                }
              }
            }
          }
          __syncthreads();

          // dV += P^T dO (group 0), dK += dS^T Q (group 1): keys 4 gy .. + 3,
          // columns 4 gx + 32 h
          {
            const float* X = group == 0 ? Ps : dSs;
            const float* Y = group == 0 ? dOt : Qt;
#pragma unroll 4
            for (int r = 0; r < q_live; ++r) {
              const float4 x4 = *reinterpret_cast<const float4*>(X + r * PST + 4 * gy);
#pragma unroll
              for (int h = 0; h < 2 * NH; ++h) {
                const float4 y = *reinterpret_cast<const float4*>(Y + r * ST + 4 * gx + 32 * h);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float xe = at(x4, e);
                  acc_kv[e][4 * h + 0] = fmaf(xe, y.x, acc_kv[e][4 * h + 0]);
                  acc_kv[e][4 * h + 1] = fmaf(xe, y.y, acc_kv[e][4 * h + 1]);
                  acc_kv[e][4 * h + 2] = fmaf(xe, y.z, acc_kv[e][4 * h + 2]);
                  acc_kv[e][4 * h + 3] = fmaf(xe, y.w, acc_kv[e][4 * h + 3]);
                }
              }
            }
          }

          // dQ += dS K: rows ty + 16 i, columns 4 tx + 64 h, key tile after
          // key tile, in order
          const int k_end = (k_live + 3) & ~3;
#pragma unroll 2
          for (int kk = 0; kk < k_end; kk += 4) {
            float4 sv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              sv[i] = *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * PST + kk);
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int h = 0; h < NH; ++h) {
                const float4 kv = *reinterpret_cast<const float4*>(Ks + (kk + e) * ST + 4 * tx +
                                                                   64 * h);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const float se = at(sv[i], e);
                  acc_q[qt][i][4 * h + 0] = fmaf(se, kv.x, acc_q[qt][i][4 * h + 0]);
                  acc_q[qt][i][4 * h + 1] = fmaf(se, kv.y, acc_q[qt][i][4 * h + 1]);
                  acc_q[qt][i][4 * h + 2] = fmaf(se, kv.z, acc_q[qt][i][4 * h + 2]);
                  acc_q[qt][i][4 * h + 3] = fmaf(se, kv.w, acc_q[qt][i][4 * h + 3]);
                }
              }
          }
          __syncthreads();  // P and dS are rewritten by the next q tile

          // on the last key tile this q tile is done with: the next item's
          // q and dO tile goes in its place
          if (last_kt && qt < next_qt) {
            const size_t next_base = next_bh * seq_elems;
            load_rows<DP>(Qs + qt * BT * ST, q + next_base, next_c0 + qt * BT, BT, seq, d);
            load_rows<DP>(dOs + qt * BT * ST, dout + next_base, next_c0 + qt * BT, BT, seq, d);
            ready = qt + 1;
          }
        }

        // dK and dV of this key tile: written by the first chunk, added to
        // by the later ones, in order
        {
          float* grad = group == 0 ? dv : dk;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 4 * gy + e;
            if (key >= seq) continue;
#pragma unroll
            for (int h = 0; h < 2 * NH; ++h) {
              const int c = 4 * gx + 32 * h;
              if (c >= d) continue;
              float4* cell = reinterpret_cast<float4*>(grad + base + (size_t)key * d + c);
              float4 x = make_float4(acc_kv[e][4 * h], acc_kv[e][4 * h + 1], acc_kv[e][4 * h + 2],
                                     acc_kv[e][4 * h + 3]);
              if (c0 > 0) {
                const float4 y = *cell;
                x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
              }
              *cell = x;
            }
          }
        }

        // one buffer: the next key tile now, into the one just read
        if (NKV == 1) {
          if (!last_kt) load_kv(0, bh, k0 + BT);
          else if (has_next) load_kv(0, next_bh, 0);
        }
        cp_async_wait_all();  // the next key tile (and prefetched q tiles) landed
        __syncthreads();
        kvb = (kvb + 1) % NKV;
      }

      // dQ of the chunk, complete
#pragma unroll
      for (int qt = 0; qt < NQT; ++qt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = c0 + qt * BT + ty + 16 * i;
          if (qt >= n_qt || row >= seq) continue;
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            const int c = 4 * tx + 64 * h;
            if (c < d)
              *reinterpret_cast<float4*>(dq + base + (size_t)row * d + c) =
                  make_float4(acc_q[qt][i][4 * h], acc_q[qt][i][4 * h + 1],
                              acc_q[qt][i][4 * h + 2], acc_q[qt][i][4 * h + 3]);
          }
        }
    }
  }
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

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, const float* out,
                   const float* dout, const float* lse, const float* dlse, float* dq, float* dk,
                   float* dv, int bh, int seq, int d, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_f32_kernel<DP>;
  const size_t bytes = Cfg<DP>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const int grid = bh < sms ? bh : sms;
  kernel<<<grid, THREADS, bytes, stream>>>(q, k, v, out, dout, lse, dlse, dq, dk, dv, bh, seq, d,
                                           scale);
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes: float32 q, k, v, out, dout (BH, S, D)
// contiguous and 16-byte aligned, lse (BH, S) float32, dlse (BH, S) float32
// or null; dq, dk, dv (BH, S, D) float32. The workspace is unused (null;
// see gordo_flash_bwd_f32_workspace). Returns the cudaError_t of the launch
// (0 on success); the caller raises.
extern "C" long long gordo_flash_bwd_f32_workspace(int bh, int seq, int d) { return 0; }

extern "C" int gordo_flash_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, const void* dlse, void* dq,
                                   void* dk, void* dv, void* workspace, int bh, int seq, int d,
                                   float scale, void* stream) {
  if (bh <= 0 || seq <= 0 || d <= 0 || d > 128 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  auto dqf = static_cast<float*>(dq), dkf = static_cast<float*>(dk),
       dvf = static_cast<float*>(dv);
  if (d <= 64)
    return (int)launch<64>(f(q), f(k), f(v), f(out), f(dout), f(lse), f(dlse), dqf, dkf, dvf, bh,
                           seq, d, scale, s);
  return (int)launch<128>(f(q), f(k), f(v), f(out), f(dout), f(lse), f(dlse), dqf, dkf, dvf, bh,
                          seq, d, scale, s);
}

extern "C" const char* gordo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
