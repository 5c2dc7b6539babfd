// Non-causal attention backward in float32 on CUDA cores, for Hopper.
//
// Replaces `_bwd_3d` in gordo_components_tpu/ops/flash_attention.py
// (:187-229), the backward half of the `jax.custom_vjp` around the Pallas
// kernel `_fwd_kernel` (pl.pallas_call at :157), which serves both
// `_flash_3d` (flash_attention) and `flash_block_with_lse`. Same contract:
// from the forward's saved q, k, v, out (BH, S, D) and lse (BH, S), the
// output cotangent dout (BH, S, D) and an optional lse cotangent dlse
// (BH, S), it gives dq, dk, dv (BH, S, D). Inputs are float32 or bfloat16
// (one instantiation each, all of q, k, v, out, dout in that dtype; lse and
// dlse float32); the arithmetic is float32 whatever the input dtype, as in
// `_bwd_3d`, and the grads are written in the input dtype. Keys and rows at
// or beyond S contribute nothing. S is any length >= 1, D any width up to
// 128 (tiles are padded to 16, 32, 64 or 128 columns).
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
// bound is operations.
//
// What the design does about it, simply (a first, right kernel; wgmma,
// TMA and a fused pass with atomics on dQ are later work):
// - Three launches, no atomics, a deterministic result. (1) A row pass
//   computes delta_i, one warp per row. (2) One block per (bh, 64-key
//   tile) walks the q tiles of its sequence, recomputes P and dS per tile,
//   and accumulates dK and dV in registers. (3) One block per (bh, 64-row
//   q tile) walks the key tiles, recomputes P and dS, and accumulates dQ.
//   So S = Q K^T and dP = dO V^T are computed twice: seven products where
//   five would do, the price of needing no atomics and no second buffer.
// - 256 threads as 16 x 16; a thread owns rows ty + 16 i and columns
//   tx + 16 j of each 64 x 64 product (interleaved, so a warp's 16 columns
//   fall in 16 banks with the odd row stride DP + 1, and its two row
//   groups read as broadcasts). Tiles are float32 in shared memory, loaded
//   with zero fill past S and past D.
// - Blocks of one sequence are adjacent in the grid and share its tiles
//   through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BT = 64;        // rows (q) or keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int PST = BT + 1;   // row stride of the P and dS tiles, in floats

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows [row0, row0 + 64) of one (S, d) matrix into a (64, DP + 1) float
// tile, zero past S and past d
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int seq, int d) {
  for (int idx = threadIdx.x; idx < BT * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP, gr = row0 + r;
    float val = 0.f;
    if (gr < seq && c < d) val = to_float(src[(size_t)gr * d + c]);
    dst[r * (DP + 1) + c] = val;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int seq) {
  for (int r = threadIdx.x; r < BT; r += THREADS) dst[r] = row0 + r < seq ? src[row0 + r] : 0.f;
}

// delta_i = sum_c dout_ic * out_ic - dlse_i, one warp per row
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                           const float* __restrict__ dlse, float* __restrict__ delta,
                           long long rows, int d) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += to_float(g[c]) * to_float(o[c]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum - (dlse != nullptr ? dlse[row] : 0.f);
}

// s = Qt Kt^T and dp = dOt Vt^T for this thread's 4 x 4 entries of the
// 64 x 64 tile pair; then p and ds, zero outside the live rows and keys
template <int DP>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, const float* lse_s,
                                       const float* delta_s, int q_live, int k_live,
                                       float scale, float p[4][4], float ds[4][4]) {
  constexpr int ST = DP + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * ST + c];
      gv[i] = dOs[(ty + 16 * i) * ST + c];
      kv[i] = Ks[(tx + 16 * i) * ST + c];
      vv[i] = Vs[(tx + 16 * i) * ST + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = tx + 16 * j;
      const bool live = r < q_live && kc < k_live;
      const float pij = live ? __expf(s[i][j] * scale - lse_s[r]) : 0.f;
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - delta_s[r]) * scale;
    }
  }
}

// one block per (bh, key tile): dK and dV of 64 keys, over every q tile
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int seq, int d, int n_tiles,
                          float scale) {
  constexpr int ST = DP + 1, NJ = DP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * ST;
  float* Qs = Vs + BT * ST;
  float* dOs = Qs + BT * ST;
  float* Ps = dOs + BT * ST;
  float* dSs = Ps + BT * PST;
  float* lse_s = dSs + BT * PST;
  float* delta_s = lse_s + BT;

  const long long b = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * BT;
  const size_t base = (size_t)b * seq * d;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k_live = min(BT, seq - k0);

  load_tile<T, DP>(Ks, k + base, k0, seq, d);
  load_tile<T, DP>(Vs, v + base, k0, seq, d);
  float acc_k[4][NJ] = {}, acc_v[4][NJ] = {};

  for (int q0 = 0; q0 < seq; q0 += BT) {
    load_tile<T, DP>(Qs, q + base, q0, seq, d);
    load_tile<T, DP>(dOs, dout + base, q0, seq, d);
    load_rows(lse_s, lse + (size_t)b * seq, q0, seq);
    load_rows(delta_s, delta + (size_t)b * seq, q0, seq);
    __syncthreads();
    const int q_live = min(BT, seq - q0);
    float p[4][4], ds[4][4];
    scores<DP>(Qs, dOs, Ks, Vs, lse_s, delta_s, q_live, k_live, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * PST + tx + 16 * j] = p[i][j];
        dSs[(ty + 16 * i) * PST + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dV[kc][c] += sum_r P[r][kc] dO[r][c];  dK[kc][c] += sum_r dS[r][kc] Q[r][c]
    for (int r = 0; r < q_live; ++r) {
      float pv[4], sv[4], gv[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * PST + ty + 16 * i];
        sv[i] = dSs[r * PST + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        gv[j] = dOs[r * ST + tx + 16 * j];
        qv[j] = Qs[r * ST + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc_v[i][j] = fmaf(pv[i], gv[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        store(dk + base + (size_t)kr * d + c, acc_k[i][j]);
        store(dv + base + (size_t)kr * d + c, acc_v[i][j]);
      }
    }
  }
}

// one block per (bh, q tile): dQ of 64 rows, over every key tile
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int seq, int d, int n_tiles, float scale) {
  constexpr int ST = DP + 1, NJ = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * ST;
  float* Ks = dOs + BT * ST;
  float* Vs = Ks + BT * ST;
  float* dSs = Vs + BT * ST;
  float* lse_s = dSs + BT * PST;
  float* delta_s = lse_s + BT;

  const long long b = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * BT;
  const size_t base = (size_t)b * seq * d;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q_live = min(BT, seq - q0);

  load_tile<T, DP>(Qs, q + base, q0, seq, d);
  load_tile<T, DP>(dOs, dout + base, q0, seq, d);
  load_rows(lse_s, lse + (size_t)b * seq, q0, seq);
  load_rows(delta_s, delta + (size_t)b * seq, q0, seq);
  float acc[4][NJ] = {};

  for (int k0 = 0; k0 < seq; k0 += BT) {
    load_tile<T, DP>(Ks, k + base, k0, seq, d);
    load_tile<T, DP>(Vs, v + base, k0, seq, d);
    __syncthreads();
    const int k_live = min(BT, seq - k0);
    float p[4][4], ds[4][4];
    scores<DP>(Qs, dOs, Ks, Vs, lse_s, delta_s, q_live, k_live, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * PST + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ[r][c] += sum_kc dS[r][kc] K[kc][c]
    for (int kc = 0; kc < k_live; ++kc) {
      float sv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * PST + kc];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[kc * ST + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= seq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(dq + base + (size_t)r * d + c, acc[i][j]);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const T* q, const T* k, const T* v, const T* out, const T* dout,
                   const float* lse, const float* dlse, T* dq, T* dk, T* dv, float* delta,
                   int bh, int seq, int d, float scale, cudaStream_t stream) {
  constexpr int ST = DP + 1;
  const long long rows = (long long)bh * seq;
  const long long delta_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  const int n_tiles = (seq + BT - 1) / BT;
  const long long blocks = (long long)bh * n_tiles;
  if (blocks > 0x7fffffffLL || delta_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;

  flash_bwd_delta_kernel<T><<<(int)delta_blocks, THREADS, 0, stream>>>(out, dout, dlse, delta,
                                                                        rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkdv_bytes = sizeof(float) * (4 * BT * ST + 2 * BT * PST + 2 * BT);
  auto dkdv = flash_bwd_dkdv_kernel<T, DP>;
  if ((err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dkdv_bytes)) != cudaSuccess)
    return err;
  dkdv<<<(int)blocks, THREADS, dkdv_bytes, stream>>>(q, k, v, dout, lse, delta, dk, dv, seq, d,
                                                     n_tiles, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t dq_bytes = sizeof(float) * (4 * BT * ST + BT * PST + 2 * BT);
  auto dqk = flash_bwd_dq_kernel<T, DP>;
  if ((err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)dq_bytes)) != cudaSuccess)
    return err;
  dqk<<<(int)blocks, THREADS, dq_bytes, stream>>>(q, k, v, dout, lse, delta, dq, seq, d, n_tiles,
                                                  scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const void* lse, const void* dlse, void* dq, void* dk, void* dv, void* delta,
             int bh, int seq, int d, float scale, void* stream) {
  if (bh <= 0 || seq <= 0 || d <= 0 || d > 128) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto dp_tag) {
    constexpr int DP = decltype(dp_tag)::value;
    return (int)launch<T, DP>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(dlse), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), static_cast<float*>(delta), bh, seq, d, scale, s);
  };
  if (d <= 16) return args(std::integral_constant<int, 16>{});
  if (d <= 32) return args(std::integral_constant<int, 32>{});
  if (d <= 64) return args(std::integral_constant<int, 64>{});
  return args(std::integral_constant<int, 128>{});
}

}  // namespace

// C entry points, bound with ctypes. q, k, v, out, dout (BH, S, D) contiguous
// in the entry's dtype; lse (BH, S) float32; dlse (BH, S) float32 or null;
// dq, dk, dv (BH, S, D) in the entry's dtype; delta (BH, S) float32 scratch.
// Each returns the cudaError_t of its launches (0 on success); the caller
// raises.
extern "C" int gordo_flash_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, const void* dlse, void* dq,
                                   void* dk, void* dv, void* delta, int bh, int seq, int d,
                                   float scale, void* stream) {
  return dispatch<float>(q, k, v, out, dout, lse, dlse, dq, dk, dv, delta, bh, seq, d, scale,
                         stream);
}

extern "C" int gordo_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                                    const void* dout, const void* lse, const void* dlse, void* dq,
                                    void* dk, void* dv, void* delta, int bh, int seq, int d,
                                    float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, dout, lse, dlse, dq, dk, dv, delta, bh, seq, d,
                                 scale, stream);
}

extern "C" const char* gordo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
