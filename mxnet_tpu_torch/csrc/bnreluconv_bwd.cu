// Backward pass 1 of the fused BatchNorm -> ReLU -> 1x1-conv block for
// Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas_conv.py: _bwd_kernel
// (launched by _bwd_pass1_pallas) and computes what it computes, on the
// channel-last [M, C] views of one bottleneck tail:
//
//   act     = cast_T(u * g + b)          (g, b: the BN scale/shift, fp32)
//   mask    = float(act) > 0             (on the CAST value)
//   d_act   = dy . W^T                   (fp32 accumulation)
//   d_bn    = cast_T(mask ? d_act : 0)
//   dW      = relu_act^T . dy            (relu_act = mask ? act : 0; fp32)
//   s1      = sum_rows (mask ? d_act : 0)            (fp32, pre-cast)
//   s2      = sum_rows (mask ? d_act : 0) * xhat     (xhat = (u - mu) * inv)
//
// Layout: dy [M, Co], u [M, Ci], wt [Co, Ci] (the O*kI weight itself, so
// w2 = wt^T as the reference passes it), all of one dtype T (fp32 or bf16),
// contiguous; g, b, mu, inv [Ci] fp32.  Outputs d_bn [M, Ci] (T),
// dw [Ci, Co] fp32, s [2, Ci] fp32 (s1 then s2).  Scratch from the caller:
// s_part [2, groups, Ci] and dw_part [splits, Ci, Co], fp32.
//
// Design (simple first).  The TPU kernel walks a sequential grid and carries
// dW/s1/s2 in VMEM scratch from step to step; on the card blocks run in
// parallel, so the work splits in two passes and partial sums are reduced
// in a fixed order afterwards -- no float atomics, so two runs give the same
// bits:
//   1. dact_kernel: grid (Ci tiles, row groups).  A CTA walks its group's
//      64-row blocks, forms a 64x64 tile of d_act (K = Co), writes d_bn and
//      keeps per-column s1/s2 partials in registers; one partial per group.
//   2. dw_kernel: grid (Ci tiles x Co tiles, M splits).  Split-K over M: a
//      CTA forms its 64x64 tile of relu_act^T . dy over its rows, recomputing
//      relu_act from u on the fly; one partial per split.
//   3. reduce_dw_kernel / reduce_s_kernel: sum the partials in order.
// Products are fp32 FMAs from 16-deep shared-memory tiles (4x4 outputs per
// thread, 256 threads); no tensor cores, no TMA.  dy and u are read twice
// (once per pass); reading them once, and wgmma, are later work.
//
// What bounds it on an H100: the function moves dy and u once and writes
// d_bn (bytes) and does 4 * M * Ci * Co FLOPs.  At ResNet-50's batch-128
// shapes that is about 26 GFLOP per call against 0.03-0.09 ms of bytes, so
// the bf16 bound is the tensor cores' 989 TFLOP/s at stages 3-4 and the
// bytes at stages 1-2; this kernel runs on the fp32 CUDA cores instead, so
// it sits far from that bound.  Rows >= M, and columns past Ci or Co, are
// zero in every product and every sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // output tile rows and columns
constexpr int kDepth = 16;     // K slice staged in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// act = cast_T(u * g + b) as a float, with the multiply and the add rounded
// separately (no FMA contraction), as the plain version computes it.
template <typename T>
__device__ __forceinline__ float bn_act(float u32, float g, float b) {
  return to_f(from_f<T>(__fadd_rn(__fmul_rn(u32, g), b)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dact_kernel(const T* __restrict__ dy, const T* __restrict__ u,
            const T* __restrict__ wt, const float* __restrict__ g,
            const float* __restrict__ b, const float* __restrict__ mu,
            const float* __restrict__ inv, T* __restrict__ d_bn,
            float* __restrict__ s_part, int m, int ci, int co,
            int groups) {
  __shared__ float a_s[kDepth][kTile + 1];  // dy tile, [k][row]
  __shared__ float b_s[kDepth][kTile];      // wt tile, [k][ci]
  __shared__ float red[2][16][kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16 j
  const int ty = tid / 16;  // output rows ty + 16 i
  const int ci0 = blockIdx.x * kTile;
  const int grp = blockIdx.y;
  const int n_blocks = (m + kTile - 1) / kTile;
  const int per = (n_blocks + groups - 1) / groups;
  const int rb_begin = grp * per;
  const int rb_end = min(n_blocks, rb_begin + per);

  float cg[4], cb[4], cmu[4], cinv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = ci0 + tx + 16 * j;
    const bool ok = c < ci;
    cg[j] = ok ? g[c] : 0.f;
    cb[j] = ok ? b[c] : 0.f;
    cmu[j] = ok ? mu[c] : 0.f;
    cinv[j] = ok ? inv[c] : 0.f;
  }
  float s1[4] = {0.f, 0.f, 0.f, 0.f};
  float s2[4] = {0.f, 0.f, 0.f, 0.f};

  for (int rb = rb_begin; rb < rb_end; ++rb) {
    const int m0 = rb * kTile;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < co; k0 += kDepth) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int idx = tid + kThreads * q;
        const int r = idx / kDepth, kk = idx % kDepth;  // dy: k fastest
        const bool ok = m0 + r < m && k0 + kk < co;
        a_s[kk][r] = ok ? to_f(dy[(int64_t)(m0 + r) * co + k0 + kk]) : 0.f;
        const int kb = idx / kTile, c = idx % kTile;  // wt: ci fastest
        const bool okb = k0 + kb < co && ci0 + c < ci;
        b_s[kb][c] = okb ? to_f(wt[(int64_t)(k0 + kb) * ci + ci0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = ci0 + tx + 16 * j;
        if (c >= ci) continue;
        const int64_t at = (int64_t)row * ci + c;
        const float u32 = to_f(u[at]);
        const bool mask = bn_act<T>(u32, cg[j], cb[j]) > 0.f;
        const float d = mask ? acc[i][j] : 0.f;
        d_bn[at] = from_f<T>(d);
        const float xhat = __fmul_rn(__fsub_rn(u32, cmu[j]), cinv[j]);
        s1[j] += d;
        s2[j] = fmaf(d, xhat, s2[j]);
      }
    }
  }

  // per-column partials of this CTA: sum the 16 row-threads in order
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx + 16 * j] = s1[j];
    red[1][ty][tx + 16 * j] = s2[j];
  }
  __syncthreads();
  if (tid < 2 * kTile) {
    const int which = tid / kTile, c = tid % kTile;
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) sum += red[which][t][c];
    if (ci0 + c < ci)
      s_part[((int64_t)which * groups + grp) * ci + ci0 + c] = sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dw_kernel(const T* __restrict__ dy, const T* __restrict__ u,
          const float* __restrict__ g, const float* __restrict__ b,
          float* __restrict__ dw_part, int m, int ci, int co, int splits) {
  __shared__ float a_s[kDepth][kTile];  // relu_act tile, [m][ci]
  __shared__ float b_s[kDepth][kTile];  // dy tile, [m][co]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns (co) tx + 16 j
  const int ty = tid / 16;  // output rows (ci) ty + 16 i
  const int co_tiles = (co + kTile - 1) / kTile;
  const int ci0 = (blockIdx.x / co_tiles) * kTile;
  const int co0 = (blockIdx.x % co_tiles) * kTile;
  const int split = blockIdx.y;
  const int rows = ((m + splits - 1) / splits + kDepth - 1) / kDepth * kDepth;
  const int r_begin = split * rows;
  const int r_end = min(m, r_begin + rows);

  // every load of this thread touches column idx % 64 == tid % 64
  const int lc = tid % kTile;
  const bool lc_ok = ci0 + lc < ci;
  const float lg = lc_ok ? g[ci0 + lc] : 0.f;
  const float lb = lc_ok ? b[ci0 + lc] : 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kDepth) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = tid + kThreads * q;
      const int mm = idx / kTile;
      const int row = r0 + mm;
      const bool live = row < r_end;
      float a = 0.f;
      if (live && lc_ok) {
        const float act = bn_act<T>(to_f(u[(int64_t)row * ci + ci0 + lc]),
                                    lg, lb);
        a = act > 0.f ? act : 0.f;
      }
      a_s[mm][lc] = a;
      b_s[mm][lc] = live && co0 + lc < co
                        ? to_f(dy[(int64_t)row * co + co0 + lc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ci0 + ty + 16 * i;
    if (r >= ci) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = co0 + tx + 16 * j;
      if (c < co) dw_part[((int64_t)split * ci + r) * co + c] = acc[i][j];
    }
  }
}

// dw[i] = sum over splits of dw_part[s][i], in split order
__global__ void __launch_bounds__(kThreads)
reduce_dw_kernel(const float* __restrict__ dw_part, float* __restrict__ dw,
                 int64_t n, int splits) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += dw_part[(int64_t)s * n + i];
  dw[i] = sum;
}

// s[w][c] = sum over groups of s_part[w][grp][c]: one warp per (w, c),
// lanes take groups lane, lane + 32, ..., then a fixed shuffle tree
__global__ void __launch_bounds__(kThreads)
reduce_s_kernel(const float* __restrict__ s_part, float* __restrict__ s,
                int ci, int groups) {
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= 2 * ci) return;  // whole warps leave together
  const int which = warp / ci, c = warp % ci;
  float sum = 0.f;
  for (int grp = lane; grp < groups; grp += 32)
    sum += s_part[((int64_t)which * groups + grp) * ci + c];
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) s[(int64_t)which * ci + c] = sum;
}

template <typename T>
int launch(const void* dy, const void* u, const void* wt, const float* g,
           const float* b, const float* mu, const float* inv, void* d_bn,
           float* dw, float* s, float* s_part, float* dw_part, int m, int ci,
           int co, int groups, int splits, cudaStream_t st) {
  const int ci_tiles = (ci + kTile - 1) / kTile;
  const int co_tiles = (co + kTile - 1) / kTile;
  dact_kernel<T><<<dim3(ci_tiles, groups), kThreads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(u),
      static_cast<const T*>(wt), g, b, mu, inv, static_cast<T*>(d_bn), s_part,
      m, ci, co, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_kernel<T><<<dim3(ci_tiles * co_tiles, splits), kThreads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(u), g, b, dw_part, m,
      ci, co, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_dw = (int64_t)ci * co;
  reduce_dw_kernel<<<(unsigned)((n_dw + kThreads - 1) / kThreads), kThreads,
                     0, st>>>(dw_part, dw, n_dw, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = kThreads / 32;
  reduce_s_kernel<<<(2 * ci + warps_per_block - 1) / warps_per_block,
                    kThreads, 0, st>>>(s_part, s, ci, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = fp32, 1 = bf16.  Returns the
// cudaError_t of the launches (0 = all four launched).
extern "C" int mxt_bnreluconv_bwd(const void* dy, const void* u,
                                  const void* wt, const void* g,
                                  const void* b, const void* mu,
                                  const void* inv, void* d_bn, void* dw,
                                  void* s, void* s_part, void* dw_part, int m,
                                  int ci, int co, int groups, int splits,
                                  int dtype, void* stream) {
  if (m <= 0 || ci <= 0 || co <= 0 || groups <= 0 || splits <= 0 ||
      groups > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const long long ci_tiles = (ci + kTile - 1) / kTile;
  if (ci_tiles * ((co + kTile - 1) / kTile) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  const float* muf = static_cast<const float*>(mu);
  const float* invf = static_cast<const float*>(inv);
  float* dwf = static_cast<float*>(dw);
  float* sf = static_cast<float*>(s);
  float* spf = static_cast<float*>(s_part);
  float* dwpf = static_cast<float*>(dw_part);
  if (dtype == 0)
    return launch<float>(dy, u, wt, gf, bf, muf, invf, d_bn, dwf, sf, spf,
                         dwpf, m, ci, co, groups, splits, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dy, u, wt, gf, bf, muf, invf, d_bn, dwf, sf,
                                 spf, dwpf, m, ci, co, groups, splits, st);
  return (int)cudaErrorInvalidValue;
}
