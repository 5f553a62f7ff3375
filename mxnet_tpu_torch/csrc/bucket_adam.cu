// Fused flat-bucket Adam update for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel mxnet_tpu/ops/pallas_opt.py: _adam_kernel
// with its loss-scale verdict _nf_accumulate (launched through
// _elementwise_call by bucket_update) and computes what it computes, over
// one flat fp32 bucket of n elements:
//
//   gp  = clip(g * rescale)                  (Optimizer._prep; NaN passes)
//   gw  = gp + wd * w
//   m'  = beta1 * m + (1 - beta1) * gw
//   v'  = beta2 * v + ((1 - beta2) * gw) * gw
//   w'  = w - (lr_t * m') / (sqrt(v') + eps)  (_adam_step, that order)
//   nf += count of non-finite raw g           (with_finite only)
//
// lr_t, the bias-corrected rate, is one scalar computed on the host from
// the step count; 1 - beta1 and 1 - beta2 arrive as their own constants
// (rounded from the Python floats, as the reference kernel's are).  Every
// operation is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn): nvcc would otherwise contract a*b+c into an FMA
// and the result would no longer be bit-identical to the plain PyTorch
// version, which runs one rounded operation per kernel.  The build has no
// --use_fast_math.
//
// Layout: w, g, m, v and the outputs ow, om, ov (which may alias w, m, v
// for an in-place update) are flat, contiguous fp32, n elements,
// bounds-checked (the TPU kernel's (rows, 128) lane padding has no
// counterpart).  nf is one int32 the caller zeroes; the count is exact and
// order-free (int32 atomics, one per CTA) and stays on the device.
//
// What bounds it on an H100: bytes.  It reads w, g, m, v and writes w', m',
// v': 28 bytes per element, about 0.02 ms for ResNet-50's largest bucket
// (2,359,296 elements) at 3.35 TB/s.  A grid-stride loop of 256-thread CTAs
// keeps loads coalesced; 16-byte vector loads are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <bool kFinite>
__global__ void __launch_bounds__(kThreads)
bucket_adam_kernel(const float* w, const float* __restrict__ g,
                   const float* m, const float* v, float* ow, float* om,
                   float* ov, int* __restrict__ nf, int64_t n, float lr_t,
                   float wd, float beta1, float beta2, float omb1, float omb2,
                   float eps, float rescale, float clip, int has_clip) {
  int bad = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float graw = g[i];
    if (kFinite) bad += isfinite(graw) ? 0 : 1;
    float gp = __fmul_rn(graw, rescale);
    if (has_clip && gp == gp) gp = fminf(fmaxf(gp, -clip), clip);
    const float wv = w[i];
    const float gw = __fadd_rn(gp, __fmul_rn(wd, wv));
    const float mv = __fadd_rn(__fmul_rn(beta1, m[i]), __fmul_rn(omb1, gw));
    const float vv = __fadd_rn(__fmul_rn(beta2, v[i]),
                               __fmul_rn(__fmul_rn(omb2, gw), gw));
    const float den = __fadd_rn(__fsqrt_rn(vv), eps);
    ow[i] = __fsub_rn(wv, __fdiv_rn(__fmul_rn(lr_t, mv), den));
    om[i] = mv;
    ov[i] = vv;
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

}  // namespace

// C interface, loaded with ctypes.  nf is ignored without with_finite.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int mxt_bucket_adam(const float* w, const float* g, const float* m,
                               const float* v, float* ow, float* om,
                               float* ov, int* nf, long long n,
                               int with_finite, float lr_t, float wd,
                               float beta1, float beta2, float omb1,
                               float omb2, float eps, float rescale,
                               float clip, int has_clip, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  if (with_finite)
    bucket_adam_kernel<true><<<blocks, kThreads, 0, st>>>(
        w, g, m, v, ow, om, ov, nf, n, lr_t, wd, beta1, beta2, omb1, omb2,
        eps, rescale, clip, has_clip);
  else
    bucket_adam_kernel<false><<<blocks, kThreads, 0, st>>>(
        w, g, m, v, ow, om, ov, nf, n, lr_t, wd, beta1, beta2, omb1, omb2,
        eps, rescale, clip, has_clip);
  return (int)cudaGetLastError();
}
