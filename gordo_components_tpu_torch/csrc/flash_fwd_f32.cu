// Non-causal attention forward in float32 on CUDA cores, for Hopper.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`, launched by `_flash_fwd_3d`
// in gordo_components_tpu/ops/flash_attention.py (pl.pallas_call at :157).
// Same contract: q, k, v are (BH, S, D) float32, contiguous; out is
// (BH, S, D) and lse is (BH, S), the per-row logsumexp of the scaled
// scores. Keys at or beyond S are masked with -1e30 (not -inf: a masked
// score must give exp(-1e30 - m) = 0, never exp(-inf + inf) = NaN).
// D is any multiple of 4 up to 128, S any length >= 1.
//
// What bounds it on an H100: at the slice shape (BH 8192, S 179, D 64) one
// call does 4*BH*S^2*D = 67.2 GFLOP on 1.5 GB, so at 67 TFLOP/s of fp32
// outside the tensor cores the bound is operations, 1.00 ms. Every
// product is an fp32 FFMA: no TF32, no tensor-core instruction. The
// softmax's exponentials are MUFU `ex2.approx.ftz` (about 2 ulp, subnormal
// results flushed to 0), not a correctly rounded exp.
//
// What the design does about it:
// - Register tiles read from shared memory as 16-byte float4 loads along
//   the reduction axis, in both products: for S = Q K^T a thread owns 4 q
//   rows x 8 keys and per 4-wide step loads 4 float4 of Q and 8 of K for
//   128 FFMA; for O += P V it owns 4 rows x D/8 output columns and per 4
//   keys loads 4 float4 of P and 8 of V (D = 64) for 128 FFMA. Row strides
//   are padded (D + 4, BK + 8 floats) so that a warp's float4 reads and its
//   scalar P writes fall in distinct banks; a warp's 4 row groups read Q
//   and P as broadcasts.
// - Occupancy, more than shared-memory bandwidth, set the tiling on this
//   card: 8 x 8 tiles (4 FFMA per float loaded, the ratio that keeps the
//   shared-memory pipe from capping the FMAs) need 254 registers, so only
//   5.75 warps (one 184-thread block) fit on an SM, and run at 2.66 ms;
//   4 x 8 tiles need 166 registers, fit 11.25 warps (three 120-thread
//   blocks), and run at 2.21 ms (tools/flash_kernel_sweep.py, PERF.md
//   PR 2). The sweep builds its own libraries of this source with other
//   values of FLASH_F32_ROWS_PER_BLOCK and FLASH_F32_TILE_ROWS; the served
//   library takes the defaults below.
// - A block owns up to 64 q rows of one sequence (S = 179 is three blocks
//   of 60 rows, 120 threads). Larger blocks measured slower: two of 90
//   rows 2.34 ms; one of all 179 rows with 8 x 8 tiles, which reads each
//   sequence's K and V from device memory once, 2.66 ms. The q-blocks of
//   one sequence are adjacent work items, run at the same time, and share
//   K and V through L2. Threads own rows rg, rg + RG, ...,
//   interleaved so that a warp's rows are consecutive, and RG = ceil(rows /
//   4), so no row is padded beyond a multiple of 4.
// - Keys stream in chunks of BK = 64 with an online softmax (exp2 on the
//   MUFU unit) kept in the registers of the 8 lanes that share a row
//   (shuffle reductions). The score product stops at the last live column
//   group of the last chunk (JN columns of 8), and the P V product at its
//   last live key.
// - Loads overlap compute: blocks are persistent (as many as fit, walking
//   over (bh, q-block) work items), and cp.async copies with zero-fill
//   bring the next K chunk during this chunk's softmax and P V, and the
//   next V chunk during the next score product; the next work item's Q
//   and first K arrive during the current item's last chunk.
//
// Resources (nvcc 12.8, -Xptxas -v, sm_90a; tools/flash_kernel_sweep.py):
// the served <DP = 64, ROWS = 4> uses 166 registers with no spills and, at
// S = 179, 68,416 bytes of dynamic shared memory for 120 threads: 3 blocks
// (11.25 warps) per SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;      // keys per chunk
constexpr int TG = 8;       // lanes per row group (one per 8 key columns)
constexpr int PST = BK + 8; // P row stride in floats
constexpr int MAX_THREADS = 256;
#ifndef FLASH_F32_ROWS_PER_BLOCK
#define FLASH_F32_ROWS_PER_BLOCK 64  // q rows per block, at most
#endif
#ifndef FLASH_F32_TILE_ROWS
#define FLASH_F32_TILE_ROWS 4  // q rows of a thread's register tile at D <= 64
#endif
constexpr float MASK = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = live ? 16 : 0;  // 0: nothing read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 2^x on the MUFU unit (relative error ~2^-22); scores are at most 0 here,
// and -1e30 flushes to 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
struct Layout {
  static constexpr int ST = DP + 4;  // Q, K and V row stride in floats
};

// copy `rows` rows of a (S, D) sequence, starting at row r0, into a
// [rows_alloc][DP + 4] tile; rows at or past `limit` and columns at or past
// d are zero-filled
template <int DP>
__device__ __forceinline__ void load_rows(float* tile, const float* seq_base, int r0, int limit,
                                          int rows_alloc, int d, int tid, int nthreads) {
  constexpr int C4 = DP / 4;
  for (int i = tid; i < rows_alloc * C4; i += nthreads) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool live = (r0 + r < limit) && (c < d);
    const float* src = live ? seq_base + (size_t)(r0 + r) * d + c : seq_base;
    cp_async16(tile + r * Layout<DP>::ST + c, src, live);
  }
}

// s[r][j] = q(row r) . k(key cg + 8 j) over DP dims, for j < JN
template <int DP, int ROWS, int JN>
__device__ __forceinline__ void score_tile(float (&s)[ROWS][8], const float* Qs, const float* Ks,
                                           int rg, int RG, int cg) {
  constexpr int ST = Layout<DP>::ST;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[r][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < DP; c += 4) {
    float4 qv[ROWS], kv[JN];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      qv[r] = *reinterpret_cast<const float4*>(Qs + (rg + RG * r) * ST + c);
#pragma unroll
    for (int j = 0; j < JN; ++j)
      kv[j] = *reinterpret_cast<const float4*>(Ks + (cg + 8 * j) * ST + c);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        float a = s[r][j];
        a = fmaf(qv[r].x, kv[j].x, a);
        a = fmaf(qv[r].y, kv[j].y, a);
        a = fmaf(qv[r].z, kv[j].z, a);
        a = fmaf(qv[r].w, kv[j].w, a);
        s[r][j] = a;
      }
  }
}

template <int DP, int ROWS>
__device__ __forceinline__ void score_tile_trimmed(float (&s)[ROWS][8], const float* Qs,
                                                   const float* Ks, int rg, int RG, int cg,
                                                   int jn) {
  switch (jn) {
    case 1: score_tile<DP, ROWS, 1>(s, Qs, Ks, rg, RG, cg); break;
    case 2: score_tile<DP, ROWS, 2>(s, Qs, Ks, rg, RG, cg); break;
    case 3: score_tile<DP, ROWS, 3>(s, Qs, Ks, rg, RG, cg); break;
    case 4: score_tile<DP, ROWS, 4>(s, Qs, Ks, rg, RG, cg); break;
    case 5: score_tile<DP, ROWS, 5>(s, Qs, Ks, rg, RG, cg); break;
    case 6: score_tile<DP, ROWS, 6>(s, Qs, Ks, rg, RG, cg); break;
    case 7: score_tile<DP, ROWS, 7>(s, Qs, Ks, rg, RG, cg); break;
    default: score_tile<DP, ROWS, 8>(s, Qs, Ks, rg, RG, cg); break;
  }
}

// One block: RG row groups of 8 lanes; thread (rg, cg) = (tid / 8, tid % 8)
// owns rows rg + RG * r (r < ROWS) of the block's q rows, key columns
// cg + 8 j (j < 8) of each chunk, and output columns cg * 4 + 32 h .. + 3.
template <int DP, int ROWS>
__global__ void __launch_bounds__(MAX_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int seq, int d, int n_qb, int qb_rows,
                     int n_work, float scale_log2) {
  constexpr int ST = Layout<DP>::ST;
  constexpr int NC4 = DP / 32;  // float4 output columns per thread
  static_assert(DP % 32 == 0, "DP is 32, 64 or 128");

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int RG = nthreads / TG;
  const int rows_alloc = RG * ROWS;
  const int rg = tid / TG, cg = tid % TG;
  const int warp_lanes = min(32, nthreads - (tid & ~31));
  const unsigned mask = warp_lanes == 32 ? 0xffffffffu : ((1u << warp_lanes) - 1u);

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [rows_alloc][ST]
  float* Ps = Qs + rows_alloc * ST;   // [rows_alloc][PST]
  float* Ks = Ps + rows_alloc * PST;  // [BK][ST]
  float* Vs = Ks + BK * ST;           // [BK][ST]

  const int n_chunks = (seq + BK - 1) / BK;
  const size_t seq_elems = (size_t)seq * d;

  int w = blockIdx.x;
  if (w >= n_work) return;  // uniform over the block
  // prologue: the first work item's Q with its first K chunk, then its first V chunk
  {
    const int bh = w / n_qb, r0 = (w % n_qb) * qb_rows;
    const int r_end = min(seq, r0 + qb_rows);
    load_rows<DP>(Qs, q + bh * seq_elems, r0, r_end, rows_alloc, d, tid, nthreads);
    load_rows<DP>(Ks, k + bh * seq_elems, 0, seq, BK, d, tid, nthreads);
    cp_async_commit();
    load_rows<DP>(Vs, v + bh * seq_elems, 0, seq, BK, d, tid, nthreads);
    cp_async_commit();
  }

  for (; w < n_work; w += gridDim.x) {
    const int bh = w / n_qb, r0 = (w % n_qb) * qb_rows;
    const int w_next = w + gridDim.x;
    float m[ROWS], l[ROWS], acc[ROWS][4 * NC4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      m[r] = MASK;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < 4 * NC4; ++c) acc[r][c] = 0.f;
    }

    for (int kc = 0; kc < n_chunks; ++kc) {
      const int k0 = kc * BK;
      const int live = min(BK, seq - k0);  // keys of this chunk below S
      cp_async_wait_all_but_newest();      // Q and this chunk's K have landed
      __syncthreads();

      float s[ROWS][8];
      score_tile_trimmed<DP, ROWS>(s, Qs, Ks, rg, RG, cg, (live + 7) / 8);
      __syncthreads();  // K (and Q on the last chunk) no longer read

      // next K chunk, or the next work item's Q and first K chunk
      if (kc + 1 < n_chunks) {
        load_rows<DP>(Ks, k + bh * seq_elems, k0 + BK, seq, BK, d, tid, nthreads);
      } else if (w_next < n_work) {
        const int bh2 = w_next / n_qb, r2 = (w_next % n_qb) * qb_rows;
        load_rows<DP>(Qs, q + bh2 * seq_elems, r2, min(seq, r2 + qb_rows), rows_alloc, d, tid,
                      nthreads);
        load_rows<DP>(Ks, k + bh2 * seq_elems, 0, seq, BK, d, tid, nthreads);
      }
      cp_async_commit();

      // online softmax in the log2 domain; the 8 lanes of a row group hold
      // the row's 64 columns and agree on m and l after the shuffles
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float tile_max = MASK;
        if (live == BK) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[r][j] *= scale_log2;
            tile_max = fmaxf(tile_max, s[r][j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[r][j] = (cg + 8 * j < live) ? s[r][j] * scale_log2 : MASK;
            tile_max = fmaxf(tile_max, s[r][j]);
          }
        }
#pragma unroll
        for (int off = 1; off < TG; off <<= 1)
          tile_max = fmaxf(tile_max, __shfl_xor_sync(mask, tile_max, off));
        const float m_new = fmaxf(m[r], tile_max);
        const float corr = fast_exp2(m[r] - m_new);
        float tile_sum = 0.f;
        float* prow = Ps + (rg + RG * r) * PST + cg;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = fast_exp2(s[r][j] - m_new);
          tile_sum += p;
          prow[8 * j] = p;
        }
#pragma unroll
        for (int off = 1; off < TG; off <<= 1)
          tile_sum += __shfl_xor_sync(mask, tile_sum, off);
        l[r] = l[r] * corr + tile_sum;
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < 4 * NC4; ++c) acc[r][c] *= corr;
      }

      cp_async_wait_all_but_newest();  // this chunk's V has landed
      __syncthreads();                 // and every lane's P is written

      // acc += P V over the chunk's live keys, four at a time
      const int kmax = (live + 3) & ~3;
#pragma unroll(ROWS == 4 ? 2 : 1)
      for (int kk = 0; kk < kmax; kk += 4) {
        float4 pv[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          pv[r] = *reinterpret_cast<const float4*>(Ps + (rg + RG * r) * PST + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4 vv[NC4];
#pragma unroll
          for (int h = 0; h < NC4; ++h)
            vv[h] = *reinterpret_cast<const float4*>(Vs + (kk + i) * ST + cg * 4 + 32 * h);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float p = i == 0 ? pv[r].x : i == 1 ? pv[r].y : i == 2 ? pv[r].z : pv[r].w;
#pragma unroll
            for (int h = 0; h < NC4; ++h) {
              acc[r][4 * h + 0] = fmaf(p, vv[h].x, acc[r][4 * h + 0]);
              acc[r][4 * h + 1] = fmaf(p, vv[h].y, acc[r][4 * h + 1]);
              acc[r][4 * h + 2] = fmaf(p, vv[h].z, acc[r][4 * h + 2]);
              acc[r][4 * h + 3] = fmaf(p, vv[h].w, acc[r][4 * h + 3]);
            }
          }
        }
      }
      __syncthreads();  // V and P no longer read

      // next V chunk, or the next work item's first V chunk
      if (kc + 1 < n_chunks) {
        load_rows<DP>(Vs, v + bh * seq_elems, k0 + BK, seq, BK, d, tid, nthreads);
      } else if (w_next < n_work) {
        load_rows<DP>(Vs, v + (w_next / n_qb) * seq_elems, 0, seq, BK, d, tid, nthreads);
      }
      cp_async_commit();
    }

    // epilogue: normalise and write this item's rows
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = r0 + rg + RG * r;
      if (rg + RG * r >= qb_rows || row >= seq) continue;
      const float inv = 1.f / l[r];
      float* orow = out + bh * seq_elems + (size_t)row * d;
#pragma unroll
      for (int h = 0; h < NC4; ++h) {
        const int c = cg * 4 + 32 * h;
        if (c < d)
          *reinterpret_cast<float4*>(orow + c) =
              make_float4(acc[r][4 * h] * inv, acc[r][4 * h + 1] * inv, acc[r][4 * h + 2] * inv,
                          acc[r][4 * h + 3] * inv);
      }
      if (cg == 0) lse[(size_t)bh * seq + row] = (m[r] + log2f(l[r])) * LN2;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // nothing left in flight at exit
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

template <int DP, int ROWS>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, float* lse, int bh,
                   int seq, int d, float scale, cudaStream_t stream) {
  // q rows per block: FLASH_F32_ROWS_PER_BLOCK, up to what MAX_THREADS
  // threads hold; longer sequences are split evenly into q-blocks
  const int most = MAX_THREADS / TG * ROWS;
  const int max_rows = FLASH_F32_ROWS_PER_BLOCK < most ? FLASH_F32_ROWS_PER_BLOCK : most;
  const int n_qb = (seq + max_rows - 1) / max_rows;
  const int qb_rows = (seq + n_qb - 1) / n_qb;
  const int rg = (qb_rows + ROWS - 1) / ROWS;
  const int threads = rg * TG;
  const int rows_alloc = rg * ROWS;
  const size_t bytes =
      sizeof(float) * ((size_t)rows_alloc * (Layout<DP>::ST + PST) + 2 * BK * Layout<DP>::ST);
  auto kernel = flash_fwd_f32_kernel<DP, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long n_work = (long long)bh * n_qb;
  if (n_work > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sms;
  const int grid = (int)(n_work < resident ? n_work : resident);
  kernel<<<grid, threads, bytes, stream>>>(q, k, v, out, lse, seq, d, n_qb, qb_rows, (int)n_work,
                                           scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes: float32 q, k, v (BH, S, D) contiguous,
// out (BH, S, D) float32, lse (BH, S) float32. Returns the cudaError_t of
// the launch (0 on success); the caller raises.
extern "C" int gordo_flash_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int bh, int seq, int d, float scale, void* stream) {
  if (bh <= 0 || seq <= 0 || d <= 0 || d > 128 || d % 4 != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q), kf = static_cast<const float*>(k),
       vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(out), lf = static_cast<float*>(lse);
  if (d <= 32) return (int)launch<32, 4>(qf, kf, vf, of, lf, bh, seq, d, scale, s);
  if (d <= 64)
    return (int)launch<64, FLASH_F32_TILE_ROWS>(qf, kf, vf, of, lf, bh, seq, d, scale, s);
  return (int)launch<128, 4>(qf, kf, vf, of, lf, bh, seq, d, scale, s);
}

extern "C" const char* gordo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
