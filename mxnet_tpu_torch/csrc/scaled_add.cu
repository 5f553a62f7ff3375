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
// are 16-byte aligned the kernel moves 16-byte vectors (8 bf16/fp16, 4
// fp32/int32, 2 int64); otherwise one element at a time.
//
// What bounds it on an H100: bytes.  It reads x and y and writes out once,
// 3 x n x sizeof(T): 616.6 MB for ResNet-50's largest residual add at
// batch 128 in bf16 (128x56x56x256), 0.184 ms at 3.35 TB/s; it does one
// multiply and one add per element, far below any compute bound.
//
// Design, for the memory rate: one pass, no grid-stride loop.  Each thread
// of a 256-thread CTA owns kUnroll vectors a CTA-width apart and issues all
// 2 x kUnroll loads before any arithmetic, so every thread has that many
// 16-byte requests in flight; the grid is ceil(vectors / (256 x kUnroll))
// CTAs.  Loads and stores carry the streaming hint (ld.global.cs /
// st.global.cs, evict-first): each byte is touched once.  The ragged tail
// (fewer than one vector) is one extra CTA of its own.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;             // 16-byte vectors per thread
constexpr int kMaxBlocks = 132 * 16;   // the unaligned path's grid

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

// blocks [0, main_blocks) do the vectors; block main_blocks the tail
template <typename T>
__global__ void __launch_bounds__(kThreads)
scaled_add_vec(const T* __restrict__ x, const T* __restrict__ y,
               T* __restrict__ o, int64_t n, typename Op<T>::S s,
               unsigned main_blocks) {
  constexpr int kLanes = 16 / sizeof(T);
  const int64_t nvec = n / kLanes;
  if (blockIdx.x == main_blocks) {  // the ragged tail, < kLanes elements
    const int64_t i = nvec * kLanes + threadIdx.x;
    if (i < n) o[i] = Op<T>::apply(x[i], y[i], s);
    return;
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(o);
  const int64_t i0 = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  uint4 a[kUnroll], b[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = i0 + u * kThreads;
    if (i < nvec) {
      a[u] = __ldcs(xv + i);
      b[u] = __ldcs(yv + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = i0 + u * kThreads;
    if (i < nvec) {
      Vec<T> va, vb, vc;
      memcpy(&va, &a[u], 16);
      memcpy(&vb, &b[u], 16);
#pragma unroll
      for (int j = 0; j < kLanes; ++j)
        vc.v[j] = Op<T>::apply(va.v[j], vb.v[j], s);
      uint4 c;
      memcpy(&c, &vc, 16);
      __stcs(ov + i, c);
    }
  }
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
  if (aligned) {
    const int64_t nvec = n / (16 / sizeof(T));
    const int64_t main_blocks =
        (nvec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
    const bool tail = nvec * (int64_t)(16 / sizeof(T)) < n;
    if (main_blocks + 1 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    scaled_add_vec<T><<<(unsigned)(main_blocks + (tail ? 1 : 0)), kThreads,
                        0, st>>>(xp, yp, op, n, s, (unsigned)main_blocks);
  } else {
    const int64_t want = (n + kThreads - 1) / kThreads;
    const unsigned blocks =
        (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
    scaled_add_scalar<T><<<blocks, kThreads, 0, st>>>(xp, yp, op, n, s);
  }
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
