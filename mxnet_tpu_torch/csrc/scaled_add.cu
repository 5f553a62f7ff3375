// Scaled elementwise add for Hopper (sm_90a), CUDA C++:  out = x + y * s.
//
// Replaces the Pallas TPU kernel example/plugin/pallas_ops.py
// _scaled_add_pallas (the operator plugin's scaled residual add, reached
// through mx.library.load) and computes what it computes, with the scale
// already rounded to the array's dtype (the reference's
// jnp.asarray(scale, x.dtype)).  Every step is rounded as PyTorch's two
// kernels of the plain version round it: t = round(y * s), then
// out = round(x + t), each in fp32 for fp32/bf16/fp16 data, with
// __fmul_rn/__fadd_rn so that nvcc does not contract them into one FMA.
// So the kernel is bit-identical to `x + y * s` on the card.  int32 and
// int64 wrap, as PyTorch's integer ops do.
//
// Layout: x, y, out contiguous, of one dtype, n elements.  When all three
// are 16-byte aligned each thread moves 16 bytes a step (8 bf16/fp16, 4
// fp32/int32, 2 int64) and block 0 finishes the ragged tail; otherwise one
// element a step.  Grid-stride loops of 256-thread CTAs.
//
// What bounds it on an H100: bytes.  It reads x and y and writes out once,
// 3 x n x sizeof(T): 616.6 MB for ResNet-50's largest residual add at
// batch 128 in bf16 (128x56x56x256), 0.184 ms at 3.35 TB/s; it does one
// multiply and one add per element, far below any compute bound.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename T>
struct Op;
template <>
struct Op<float> {
  using S = float;
  static __device__ __forceinline__ float apply(float x, float y, float s) {
    return __fadd_rn(x, __fmul_rn(y, s));
  }
};
template <>
struct Op<__nv_bfloat16> {
  using S = float;
  static __device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 x,
                                                        __nv_bfloat16 y,
                                                        float s) {
    const float t =
        __bfloat162float(__float2bfloat16_rn(__fmul_rn(__bfloat162float(y),
                                                       s)));
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(x), t));
  }
};
template <>
struct Op<__half> {
  using S = float;
  static __device__ __forceinline__ __half apply(__half x, __half y,
                                                 float s) {
    const float t = __half2float(__float2half_rn(__fmul_rn(__half2float(y),
                                                           s)));
    return __float2half_rn(__fadd_rn(__half2float(x), t));
  }
};
template <>
struct Op<int32_t> {
  using S = int64_t;
  static __device__ __forceinline__ int32_t apply(int32_t x, int32_t y,
                                                  int64_t s) {
    return (int32_t)((uint32_t)x + (uint32_t)y * (uint32_t)s);
  }
};
template <>
struct Op<int64_t> {
  using S = int64_t;
  static __device__ __forceinline__ int64_t apply(int64_t x, int64_t y,
                                                  int64_t s) {
    return (int64_t)((uint64_t)x + (uint64_t)y * (uint64_t)s);
  }
};

template <typename T>
struct alignas(16) Vec {
  T v[16 / sizeof(T)];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
scaled_add_vec(const T* __restrict__ x, const T* __restrict__ y,
               T* __restrict__ o, int64_t n, typename Op<T>::S s) {
  constexpr int kLanes = 16 / sizeof(T);
  const int64_t nvec = n / kLanes;
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
  const Vec<T>* yv = reinterpret_cast<const Vec<T>*>(y);
  Vec<T>* ov = reinterpret_cast<Vec<T>*>(o);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += stride) {
    const Vec<T> a = xv[i];
    const Vec<T> b = yv[i];
    Vec<T> c;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) c.v[j] = Op<T>::apply(a.v[j], b.v[j], s);
    ov[i] = c;
  }
  const int64_t i = nvec * kLanes + threadIdx.x;  // the ragged tail
  if (blockIdx.x == 0 && i < n) o[i] = Op<T>::apply(x[i], y[i], s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scaled_add_scalar(const T* __restrict__ x, const T* __restrict__ y,
                  T* __restrict__ o, int64_t n, typename Op<T>::S s) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    o[i] = Op<T>::apply(x[i], y[i], s);
}

template <typename T>
int launch(const void* x, const void* y, void* o, int64_t n,
           typename Op<T>::S s, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  T* op = static_cast<T*>(o);
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)y | (uintptr_t)o) % 16) == 0;
  const int64_t per_thread = aligned ? 16 / sizeof(T) : 1;
  const int64_t items = (n + per_thread - 1) / per_thread;
  const int64_t want = (items + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  if (aligned)
    scaled_add_vec<T><<<blocks, kThreads, 0, st>>>(xp, yp, op, n, s);
  else
    scaled_add_scalar<T><<<blocks, kThreads, 0, st>>>(xp, yp, op, n, s);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = fp32, 1 = bf16, 2 = fp16,
// 3 = int32, 4 = int64.  The scale arrives rounded to the dtype: as
// scale_f for the float types, as scale_i for the integer ones.  Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int mxt_scaled_add(const void* x, const void* y, void* out,
                              long long n, int dtype, float scale_f,
                              long long scale_i, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, y, out, n, scale_f, st);
    case 1:
      return launch<__nv_bfloat16>(x, y, out, n, scale_f, st);
    case 2:
      return launch<__half>(x, y, out, n, scale_f, st);
    case 3:
      return launch<int32_t>(x, y, out, n, scale_i, st);
    case 4:
      return launch<int64_t>(x, y, out, n, scale_i, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
