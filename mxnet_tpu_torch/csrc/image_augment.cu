// Decoded-image augment for Hopper (sm_90a), CUDA C++: one launch turns a
// batch of decoded RGB uint8 HWC images of any sizes into the normalised
// NCHW float32 batch a training step takes.
//
// Replaces no TPU kernel.  It replaces host C++: what
// src/recordio_native.cc decode_augment_batch computes after its libjpeg
// decode (:142-214), so that ImageRecordIter on a CUDA target decodes with
// nvJPEG (csrc/jpeg_nvjpeg.cu) and augments on the card, and the host
// never touches a pixel.  Per image, in the C++'s order:
//   1. resize-short (when asked): ResizeBilinear (:77-105) of the decoded
//      image to (rh, rw), each channel value rounded to uint8 by
//      (uint8)(v + 0.5f);
//   2. a crop of (out_h, out_w) at the drawn origin (x0, y0), or, when the
//      image is smaller than the crop, ResizeBilinear of the whole frame
//      to (out_h, out_w), again to uint8;
//   3. the mirror (column out_w - 1 - x);
//   4. (v - mean[c]) / std[c] into plane c of the output.
// The new side of step 1 and the crop origin are computed on the host by
// the wrapper with the C++'s own arithmetic (double for the side, float
// for the origin, see ops/image_augment.py), and passed in per image.
// Every float operation of ResizeBilinear and of the normalisation is
// written with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, in the C++'s
// order, so nvcc cannot contract a product and a sum into one FMA: the
// kernel's output equals the C++'s bit for bit on the same decoded pixels.
//
// Layout: src is one uint8 buffer holding every image, image i at
// src_off[i] with (sh[i], sw[i], 3) HWC; out is (n, 3, out_h, out_w)
// float32, contiguous.  Per image (int32 each): rh/rw (the resized size;
// equal to sh/sw with resize off), resize (1 when step 1 runs), x0/y0
// (the crop origin in the resized image, or -1 for the whole-frame
// resize), mirror.
//
// What bounds it on an H100: bytes.  It writes n x 3 x out_h x out_w
// floats (77.1 MB at batch 128, 224²) and reads the source pixels each
// crop window maps to (a resize-short of 500x375 to 341x256 and a 224²
// crop touch about 330x330 of the 500x375 pixels: 41.6 MB for 128
// images; a whole-frame resize reads the whole image): 0.035 ms at 3.35
// TB/s.  A bilinear tap costs about 12 float operations, far below any
// compute bound.
//
// Design, simple first: one thread per output pixel of one image (grid y =
// image, grid x = pixel blocks of 256), all three channels per thread.
// A pixel of the cropped path reads its resized pixel, which is four taps
// of the decoded image (one when resize is off); the whole-frame path
// reads four resized pixels, so sixteen taps.  The intermediate resized
// image is never stored.  Neighbouring threads read neighbouring source
// pixels, so the loads coalesce through L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One channel value of ResizeBilinear(src (sh, sw) -> (dh, dw)) at
// (y, x), rounded to uint8 as the C++ rounds it.
__device__ __forceinline__ uint8_t bilinear(const uint8_t* src, int sh,
                                            int sw, int dh, int dw, int y,
                                            int x, int c) {
  const float sy = dh > 1 ? __fdiv_rn(float(sh - 1), float(dh - 1)) : 0.f;
  const float sx = dw > 1 ? __fdiv_rn(float(sw - 1), float(dw - 1)) : 0.f;
  const float fy = __fmul_rn(float(y), sy);
  const int64_t y0 = static_cast<int64_t>(fy);
  const int64_t y1 = min(y0 + 1, static_cast<int64_t>(sh - 1));
  const float wy = __fsub_rn(fy, float(y0));
  const float fx = __fmul_rn(float(x), sx);
  const int64_t x0 = static_cast<int64_t>(fx);
  const int64_t x1 = min(x0 + 1, static_cast<int64_t>(sw - 1));
  const float wx = __fsub_rn(fx, float(x0));
  const int64_t ssw = sw;
  const float v00 = src[(y0 * ssw + x0) * 3 + c];
  const float v01 = src[(y0 * ssw + x1) * 3 + c];
  const float v10 = src[(y1 * ssw + x0) * 3 + c];
  const float v11 = src[(y1 * ssw + x1) * 3 + c];
  const float ay = __fsub_rn(1.f, wy);
  const float ax = __fsub_rn(1.f, wx);
  // v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx,
  // left to right, each product and sum rounded on its own
  const float t0 = __fmul_rn(__fmul_rn(v00, ay), ax);
  const float t1 = __fmul_rn(__fmul_rn(v01, ay), wx);
  const float t2 = __fmul_rn(__fmul_rn(v10, wy), ax);
  const float t3 = __fmul_rn(__fmul_rn(v11, wy), wx);
  const float v = __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3);
  return static_cast<uint8_t>(__fadd_rn(v, 0.5f));
}

// Channel c of the resized image (rh, rw) at (y, x).
__device__ __forceinline__ uint8_t resized(const uint8_t* src, int sh,
                                           int sw, int rh, int rw,
                                           bool resize, int y, int x,
                                           int c) {
  if (!resize)
    return src[(static_cast<int64_t>(y) * sw + x) * 3 + c];
  return bilinear(src, sh, sw, rh, rw, y, x, c);
}

__global__ void augment_kernel(const uint8_t* __restrict__ src,
                               const int64_t* __restrict__ src_off,
                               const int* __restrict__ sh,
                               const int* __restrict__ sw,
                               const int* __restrict__ rh,
                               const int* __restrict__ rw,
                               const int* __restrict__ resize,
                               const int* __restrict__ x0s,
                               const int* __restrict__ y0s,
                               const int* __restrict__ mirror,
                               float* __restrict__ out, int out_h,
                               int out_w, float m0, float m1, float m2,
                               float s0, float s1, float s2) {
  const int i = blockIdx.y;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t plane = static_cast<int64_t>(out_h) * out_w;
  if (pix >= plane) return;
  const int y = static_cast<int>(pix / out_w);
  const int x = static_cast<int>(pix % out_w);
  const int sx = mirror[i] ? (out_w - 1 - x) : x;
  const uint8_t* img = src + src_off[i];
  const int h = sh[i], w = sw[i], hh = rh[i], ww = rw[i];
  const bool rs = resize[i] != 0;
  const int x0 = x0s[i], y0 = y0s[i];
  const float mean[3] = {m0, m1, m2};
  const float stdv[3] = {s0, s1, s2};
  float* dst = out + static_cast<int64_t>(i) * 3 * plane + pix;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    uint8_t v;
    if (x0 >= 0) {
      v = resized(img, h, w, hh, ww, rs, y0 + y, x0 + sx, c);
    } else {
      // whole-frame bilinear of the resized image to (out_h, out_w),
      // whose taps are themselves resized pixels
      const float syf =
          out_h > 1 ? __fdiv_rn(float(hh - 1), float(out_h - 1)) : 0.f;
      const float sxf =
          out_w > 1 ? __fdiv_rn(float(ww - 1), float(out_w - 1)) : 0.f;
      const float fy = __fmul_rn(float(y), syf);
      const int ya = static_cast<int>(fy);
      const int yb = min(ya + 1, hh - 1);
      const float wy = __fsub_rn(fy, float(ya));
      const float fx = __fmul_rn(float(sx), sxf);
      const int xa = static_cast<int>(fx);
      const int xb = min(xa + 1, ww - 1);
      const float wx = __fsub_rn(fx, float(xa));
      const float v00 = resized(img, h, w, hh, ww, rs, ya, xa, c);
      const float v01 = resized(img, h, w, hh, ww, rs, ya, xb, c);
      const float v10 = resized(img, h, w, hh, ww, rs, yb, xa, c);
      const float v11 = resized(img, h, w, hh, ww, rs, yb, xb, c);
      const float ay = __fsub_rn(1.f, wy);
      const float ax = __fsub_rn(1.f, wx);
      const float t0 = __fmul_rn(__fmul_rn(v00, ay), ax);
      const float t1 = __fmul_rn(__fmul_rn(v01, ay), wx);
      const float t2 = __fmul_rn(__fmul_rn(v10, wy), ax);
      const float t3 = __fmul_rn(__fmul_rn(v11, wy), wx);
      const float f = __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3);
      v = static_cast<uint8_t>(__fadd_rn(f, 0.5f));
    }
    dst[c * plane] = __fdiv_rn(__fsub_rn(float(v), mean[c]), stdv[c]);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 when it was taken).
int mxt_image_augment(const void* src, const void* src_off, const void* sh,
                      const void* sw, const void* rh, const void* rw,
                      const void* resize, const void* x0, const void* y0,
                      const void* mirror, void* out, int n, int out_h,
                      int out_w, float m0, float m1, float m2, float s0,
                      float s1, float s2, void* stream) {
  if (n <= 0) return 0;
  const int64_t plane = static_cast<int64_t>(out_h) * out_w;
  dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads),
            static_cast<unsigned>(n));
  augment_kernel<<<grid, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src),
      static_cast<const int64_t*>(src_off), static_cast<const int*>(sh),
      static_cast<const int*>(sw), static_cast<const int*>(rh),
      static_cast<const int*>(rw), static_cast<const int*>(resize),
      static_cast<const int*>(x0), static_cast<const int*>(y0),
      static_cast<const int*>(mirror), static_cast<float*>(out), out_h,
      out_w, m0, m1, m2, s0, s1, s2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
