// Fused flat-bucket SGD / SGD-momentum update for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels mxnet_tpu/ops/pallas_opt.py: _sgd_kernel
// and _sgd_mom_kernel with their loss-scale verdict _nf_accumulate (launched
// through _elementwise_call by bucket_update) and computes what they
// compute, over one flat bucket of n elements:
//
//   gq   = cast_W(g)                         (the raw gradient, W = w's dtype)
//   gp   = clip(gq * rescale)                (Optimizer._prep; NaN passes)
//   mom  = momentum * m - lr * (gp + wd * w) (_sgd_mom_step, that order)
//   w'   = w + mom,  m' = mom                 -- or, without momentum,
//   w'   = w - lr * (gp + wd * w)            (_sgd_step)
//   nf  += count of non-finite raw g         (with_finite only)
//
// Every multiply, add and subtract is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn): nvcc would otherwise contract a*b+c into an FMA and
// the result would no longer be bit-identical to the plain PyTorch version,
// which runs one rounded operation per kernel.  For bf16 buckets every
// intermediate is also rounded to bf16, as PyTorch's bf16 ops do; the
// hyper-parameters arrive already rounded to the bucket's dtype (the
// reference's weak-typed Python scalars take the array's dtype).
//
// Layout: w, m (and the outputs ow, om, which may alias them for an
// in-place update) of dtype W in {fp32, bf16}; g of dtype G in {fp32, bf16};
// flat, contiguous, n elements, bounds-checked (the TPU kernel's
// (rows, 128) lane padding has no counterpart).  nf is one int32 the caller
// zeroes; the count is exact and order-free (int32 atomics, one per CTA),
// and it stays on the device: the caller reads the verdict without a host
// sync.
//
// What bounds it on an H100: bytes.  With momentum it reads w, g, m and
// writes w', m': 20 bytes per fp32 element, about 0.15 ms for ResNet-50's
// 25.6M parameters at 3.35 TB/s.  A grid-stride loop of 256-thread CTAs
// keeps loads coalesced; vectorized 16-byte loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename T>
struct Num;
template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p, int64_t i) {
    return p[i];
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, int64_t i, float x) {
    p[i] = x;
  }
};
template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p,
                                               int64_t i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i,
                                               float x) {
    p[i] = __float2bfloat16_rn(x);
  }
};

template <typename W, typename G, bool kMomentum, bool kFinite>
__global__ void __launch_bounds__(kThreads)
bucket_sgd_kernel(const W* w, const G* __restrict__ g, const W* m, W* ow,
                  W* om, int* __restrict__ nf, int64_t n,
                  float lr, float wd, float momentum, float rescale,
                  float clip, int has_clip) {
  using NW = Num<W>;
  int bad = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float graw = Num<G>::load(g, i);
    if (kFinite) bad += isfinite(graw) ? 0 : 1;
    float gp = NW::round(__fmul_rn(NW::round(graw), rescale));
    if (has_clip && gp == gp) gp = fminf(fmaxf(gp, -clip), clip);
    const float wv = NW::load(w, i);
    const float t = NW::round(__fadd_rn(gp, NW::round(__fmul_rn(wd, wv))));
    const float step = NW::round(__fmul_rn(lr, t));
    if (kMomentum) {
      const float mom =
          NW::round(__fsub_rn(NW::round(__fmul_rn(momentum, NW::load(m, i))),
                              step));
      NW::store(ow, i, __fadd_rn(wv, mom));
      NW::store(om, i, mom);
    } else {
      NW::store(ow, i, __fsub_rn(wv, step));
    }
  }
  if (kFinite) {
    __shared__ int warp_bad[kThreads / 32];
    bad = __reduce_add_sync(0xffffffffu, bad);
    if (threadIdx.x % 32 == 0) warp_bad[threadIdx.x / 32] = bad;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int k = 0; k < kThreads / 32; ++k) total += warp_bad[k];
      if (total) atomicAdd(nf, total);
    }
  }
}

template <typename W, typename G>
int launch(const void* w, const void* g, const void* m, void* ow, void* om,
           int* nf, int64_t n, int with_momentum, int with_finite, float lr,
           float wd, float momentum, float rescale, float clip, int has_clip,
           cudaStream_t st) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  const W* wp = static_cast<const W*>(w);
  const G* gp = static_cast<const G*>(g);
  const W* mp = static_cast<const W*>(m);
  W* owp = static_cast<W*>(ow);
  W* omp = static_cast<W*>(om);
#define MXT_SGD_LAUNCH(MOM, FIN)                                          \
  bucket_sgd_kernel<W, G, MOM, FIN><<<blocks, kThreads, 0, st>>>(         \
      wp, gp, mp, owp, omp, nf, n, lr, wd, momentum, rescale, clip, has_clip)
  if (with_momentum && with_finite) MXT_SGD_LAUNCH(true, true);
  else if (with_momentum) MXT_SGD_LAUNCH(true, false);
  else if (with_finite) MXT_SGD_LAUNCH(false, true);
  else MXT_SGD_LAUNCH(false, false);
#undef MXT_SGD_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  w_dtype / g_dtype: 0 = fp32, 1 = bf16.
// m / om are ignored without momentum, nf without with_finite.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int mxt_bucket_sgd(const void* w, const void* g, const void* m,
                              void* ow, void* om, void* nf, long long n,
                              int w_dtype, int g_dtype, int with_momentum,
                              int with_finite, float lr, float wd,
                              float momentum, float rescale, float clip,
                              int has_clip, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* nfp = static_cast<int*>(nf);
  if (w_dtype == 0 && g_dtype == 0)
    return launch<float, float>(w, g, m, ow, om, nfp, n, with_momentum,
                                with_finite, lr, wd, momentum, rescale, clip,
                                has_clip, st);
  if (w_dtype == 0 && g_dtype == 1)
    return launch<float, __nv_bfloat16>(w, g, m, ow, om, nfp, n,
                                        with_momentum, with_finite, lr, wd,
                                        momentum, rescale, clip, has_clip, st);
  if (w_dtype == 1 && g_dtype == 0)
    return launch<__nv_bfloat16, float>(w, g, m, ow, om, nfp, n,
                                        with_momentum, with_finite, lr, wd,
                                        momentum, rescale, clip, has_clip, st);
  if (w_dtype == 1 && g_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        w, g, m, ow, om, nfp, n, with_momentum, with_finite, lr, wd, momentum,
        rescale, clip, has_clip, st);
  return (int)cudaErrorInvalidValue;
}
