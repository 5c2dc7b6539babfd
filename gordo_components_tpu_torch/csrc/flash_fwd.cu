// Exact non-causal attention forward with an online softmax, for Hopper.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`, launched by `_flash_fwd_3d`
// in gordo_components_tpu/ops/flash_attention.py (pl.pallas_call at :157).
// Same contract: q, k, v are (BH, S, D); out is (BH, S, D) in q's dtype and
// lse is (BH, S) float32, the per-row logsumexp of the scaled scores. Keys
// at or beyond S are masked with -1e30 (not -inf: a tile whose keys are all
// masked must give exp(-1e30 - m) = 0, never exp(-inf + inf) = NaN).
//
// What bounds it on an H100: at the slice shape (BH 8192, S 179, D 64,
// fp32) one call does 4*BH*S^2*D = 67 GFLOP on 1.5 GB of q/k/v/out. At the
// card's 67 TFLOP/s of fp32 outside the tensor cores that is 1.0 ms of
// arithmetic against 0.45 ms of memory traffic at 3.35 TB/s, so the bound
// is operations. The design keeps every score out of device memory (the
// point of the TPU kernel too) and reads q, k and v exactly once per
// (q tile, k tile) pair from shared memory; the products run on CUDA cores
// in fp32 with register tiling. Tensor cores (wgmma, TF32 or bf16) and TMA
// are later work: this first kernel is plain and exact.
//
// Layout: one block of 128 threads per (bh, 64-row q tile), a loop over
// 64-key tiles staged in shared memory. Thread (ty, tx) = (tid / 16,
// tid % 16) owns q rows ty*8 .. ty*8+7: it holds their running max m,
// normaliser l and the accumulator columns tx, tx+16, ... in registers, so
// the softmax correction never leaves the thread. The 16 threads that share
// a row group sit in one half-warp and reduce row maxima and sums with
// shuffles. D is padded (with zeros) to DPAD in {16, 32, 64, 128}.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 8 row groups x 16 lanes
constexpr int ROWS = 8;       // q rows per thread
constexpr int KCOLS = 4;      // score columns per thread (tx + 16 * j)
constexpr float MASK = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int DPAD>
struct Smem {
  // +1 column on Q, K and P: a warp reads 16 consecutive rows of one
  // column of K (or two rows 8 apart of Q and P), and an odd stride puts
  // them in different banks
  static constexpr int QSTRIDE = DPAD + 1;
  static constexpr int KSTRIDE = DPAD + 1;
  static constexpr int PSTRIDE = BK + 1;
  static constexpr int FLOATS = BQ * QSTRIDE + BK * KSTRIDE + BK * DPAD + BQ * PSTRIDE;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
};

template <typename T, int DPAD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int seq, int d, int n_qtiles,
                 float scale) {
  constexpr int DCOLS = DPAD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                              // [BQ][QSTRIDE]
  float* Ks = Qs + BQ * Smem<DPAD>::QSTRIDE;     // [BK][KSTRIDE]
  float* Vs = Ks + BK * Smem<DPAD>::KSTRIDE;     // [BK][DPAD]
  float* Ps = Vs + BK * DPAD;                    // [BQ][PSTRIDE]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * BQ;
  const size_t base = (size_t)bh * seq * d;

  // zero everything once: padded head columns (d .. DPAD) stay zero for
  // the whole kernel and add nothing to either product
  for (int i = tid; i < Smem<DPAD>::FLOATS; i += THREADS) smem[i] = 0.f;
  __syncthreads();
  // the q tile is BQ consecutive rows of d values: one contiguous run
  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i % d;
    if (q0 + r < seq) Qs[r * Smem<DPAD>::QSTRIDE + c] = to_f32(q[base + (size_t)q0 * d + i]);
  }

  float m[ROWS], l[ROWS], acc[ROWS][DCOLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = MASK;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) acc[r][j] = 0.f;
  }

  for (int k0 = 0; k0 < seq; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BK * d; i += THREADS) {
      const int r = i / d, c = i % d;
      const bool live = k0 + r < seq;
      const size_t at = base + (size_t)k0 * d + i;
      // rows past the end are zeroed so that p = 0 meets v = 0, not garbage
      Ks[r * Smem<DPAD>::KSTRIDE + c] = live ? to_f32(k[at]) : 0.f;
      Vs[r * DPAD + c] = live ? to_f32(v[at]) : 0.f;
    }
    __syncthreads();

    // scores s = (q k^T) * scale for rows ty*8+r, columns tx+16*j
    float s[ROWS][KCOLS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DPAD; ++c) {
      float qv[ROWS], kv[KCOLS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) qv[r] = Qs[(ty * ROWS + r) * Smem<DPAD>::QSTRIDE + c];
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) kv[j] = Ks[(tx + 16 * j) * Smem<DPAD>::KSTRIDE + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < KCOLS; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

    // online softmax, one row at a time; the 16 lanes of a row group
    // hold the row's 64 columns and agree on m and l after the shuffles
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float tile_max = MASK;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const int key = k0 + tx + 16 * j;
        s[r][j] = key < seq ? s[r][j] * scale : MASK;
        tile_max = fmaxf(tile_max, s[r][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[r], tile_max);
      const float corr = expf(m[r] - m_new);
      float tile_sum = 0.f;
#pragma unroll
      for (int j = 0; j < KCOLS; ++j) {
        const float p = expf(s[r][j] - m_new);
        tile_sum += p;
        Ps[(ty * ROWS + r) * Smem<DPAD>::PSTRIDE + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, off);
      l[r] = l[r] * corr + tile_sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) acc[r][j] *= corr;
    }
    __syncthreads();  // P complete before any thread reads other lanes' columns

    // acc += P V for rows ty*8+r, head columns tx+16*j
    const int kmax = min(BK, seq - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float vv[DCOLS];
#pragma unroll
      for (int j = 0; j < DCOLS; ++j) vv[j] = Vs[kk * DPAD + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = Ps[(ty * ROWS + r) * Smem<DPAD>::PSTRIDE + kk];
#pragma unroll
        for (int j = 0; j < DCOLS; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + ty * ROWS + r;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < DCOLS; ++j) {
      const int c = tx + 16 * j;
      if (c < d) store(&out[base + (size_t)row * d + c], acc[r][j] / l[r]);
    }
    if (tx == 0) lse[(size_t)bh * seq + row] = m[r] + logf(l[r]);
  }
}

template <typename T, int DPAD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int bh, int seq, int d, float scale,
                   cudaStream_t stream) {
  const int bytes = Smem<DPAD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (seq + BQ - 1) / BQ;
  const long long blocks = (long long)bh * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<T, DPAD><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, seq, d, n_qtiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       float* lse, int bh, int seq, int d, float scale,
                       cudaStream_t stream) {
  if (d <= 16) return launch<T, 16>(q, k, v, out, lse, bh, seq, d, scale, stream);
  if (d <= 32) return launch<T, 32>(q, k, v, out, lse, bh, seq, d, scale, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, out, lse, bh, seq, d, scale, stream);
  return launch<T, 128>(q, k, v, out, lse, bh, seq, d, scale, stream);
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success); the caller raises.
extern "C" int gordo_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, void* lse, int bh, int seq, int d,
                               float scale, int dtype, void* stream) {
  if (bh <= 0 || seq <= 0 || d <= 0 || d > 128 || d % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return (int)dispatch_d<float>(q, k, v, out, l, bh, seq, d, scale, s);
  if (dtype == 1) return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, l, bh, seq, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* gordo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
