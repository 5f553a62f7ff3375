// Flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/flash_attention.py:
// _flash_kernel (launched by _flash_forward_pallas) and computes what it
// computes: softmax(q k^T * sm_scale [+ causal mask]) v with an online
// softmax (running max m, normaliser l and accumulator acc in fp32), the
// causal mask aligned bottom-right (query i sees key j iff
// j <= i + (Sk - Sq)), key tiles wholly above the diagonal skipped, and a
// fully masked row written as exactly 0 (acc / max(l, 1e-30) with acc = 0).
// The TPU kernel's pallas_pad shim (pad to 128, kv_valid / q_valid, slice)
// has no counterpart here: ragged lengths are bounds checks.
//
// Layout: q (BH, Sq, D), k/v (BH, Sk, D), contiguous, fp32 or bf16; output
// in q's dtype; arithmetic in fp32.  D is a template parameter over
// {8, 16, 32, 64, 128}.
//
// Design (simple first): one CTA of 256 threads per (BH, 64-row q tile).
// Four consecutive threads own one query row, each a strided quarter of
// head_dim for q and acc (registers); a score is their partial dot products
// summed by two xor shuffles.  K and V tiles of 32 keys are staged through
// shared memory as fp32 and every product is an fp32 FMA: no tensor cores,
// no TMA, no wgmma.
//
// What bounds it on an H100: at the generative server's bench width
// (D = 8, Sq <= 16) the work is a few thousand FLOPs and the kernel is
// bound by its launch.  At D = 128, S = 2048 it is bound by operations:
// 4 * BH * Sq * Sk * D FLOPs (halved for causal) on the fp32 FMA pipes,
// against 67 TFLOP/s fp32 or 989 TFLOP/s bf16 on the tensor cores.  A
// redesign on wgmma with TMA-fed K/V tiles is queued (ROADMAP.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;                    // query rows per CTA
constexpr int kBlockK = 32;                    // keys per shared-memory tile
constexpr int kThreadsPerRow = 4;              // threads sharing one row
constexpr int kThreads = kBlockQ * kThreadsPerRow;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int n_qtiles, int causal, float sm_scale) {
  static_assert(D % kThreadsPerRow == 0, "head_dim must split over a row");
  constexpr int kPerThread = D / kThreadsPerRow;
  __shared__ float k_tile[kBlockK][D];
  __shared__ float v_tile[kBlockK][D];

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockQ;
  const int tid = threadIdx.x;
  const int lane = tid % kThreadsPerRow;  // this thread's slice of head_dim
  const int qi = q0 + tid / kThreadsPerRow;
  const bool row_ok = qi < sq;
  const int diag = sk - sq;  // bottom-right causal alignment

  const int64_t q_row = ((int64_t)bh * sq + (row_ok ? qi : 0)) * D;
  const int64_t kv_base = (int64_t)bh * sk * D;

  // element i of this thread's slice is head_dim index i * 4 + lane: the
  // four threads of a row read neighbouring words, the eight rows of a
  // warp read the same ones (a broadcast), so shared reads never conflict
  float q_reg[kPerThread], acc[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    q_reg[i] = row_ok ? load_f32(q + q_row + i * kThreadsPerRow + lane) : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F;
  float l = 0.f;

  // the last key any row of this tile may see; tiles past it are skipped
  int last_key = sk - 1;
  if (causal) last_key = min(last_key, min(q0 + kBlockQ, sq) - 1 + diag);
  const int n_ktiles = last_key >= 0 ? last_key / kBlockK + 1 : 0;

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every row is done with the previous tile
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      const bool ok = k0 + j < sk;
      const int64_t at = kv_base + (int64_t)(k0 + j) * D + d;
      k_tile[j][d] = ok ? load_f32(k + at) : 0.f;
      v_tile[j][d] = ok ? load_f32(v + at) : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        part = fmaf(q_reg[i], k_tile[j][i * kThreadsPerRow + lane], part);
      // every lane of the warp takes part: the tile loop is uniform per CTA
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = k0 + j;
      const bool seen = key < sk && (!causal || key <= qi + diag);
      s[j] = seen ? part * sm_scale : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // the -inf guards of the reference: a row with nothing seen yet keeps
    // m = -inf, and exp(-inf - -inf) is never formed
    const float m_new = fmaxf(m, tile_max);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float alpha = isfinite(m) ? expf(m - m_safe) : 0.f;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) acc[i] *= alpha;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = isfinite(s[j]) ? expf(s[j] - m_safe) : 0.f;
      p_sum += p;
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        acc[i] = fmaf(p, v_tile[j][i * kThreadsPerRow + lane], acc[i]);
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      store_f32(o + q_row + i * kThreadsPerRow + lane, acc[i] / denom);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int sq,
            int sk, int n_qtiles, unsigned blocks, int causal, float sm_scale,
            cudaStream_t stream) {
  flash_fwd_kernel<T, D><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, n_qtiles, causal,
      sm_scale);
}

template <typename T>
bool dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
                int sq, int sk, int n_qtiles, unsigned blocks, int causal,
                float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 8: launch<T, 8>(q, k, v, o, sq, sk, n_qtiles, blocks, causal, sm_scale, stream); return true;
    case 16: launch<T, 16>(q, k, v, o, sq, sk, n_qtiles, blocks, causal, sm_scale, stream); return true;
    case 32: launch<T, 32>(q, k, v, o, sq, sk, n_qtiles, blocks, causal, sm_scale, stream); return true;
    case 64: launch<T, 64>(q, k, v, o, sq, sk, n_qtiles, blocks, causal, sm_scale, stream); return true;
    case 128: launch<T, 128>(q, k, v, o, sq, sk, n_qtiles, blocks, causal, sm_scale, stream); return true;
    default: return false;
  }
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = fp32, 1 = bf16.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int mxt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int bh,
                                       int sq, int sk, int head_dim,
                                       int dtype, int causal, float sm_scale,
                                       void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  const int n_qtiles = (sq + kBlockQ - 1) / kBlockQ;
  const long long blocks = (long long)n_qtiles * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_d<float>(head_dim, q, k, v, o, sq, sk, n_qtiles,
                           (unsigned)blocks, causal, sm_scale, st);
  else if (dtype == 1)
    ok = dispatch_d<__nv_bfloat16>(head_dim, q, k, v, o, sq, sk, n_qtiles,
                                   (unsigned)blocks, causal, sm_scale, st);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
