// nvJPEG binding with a plain C interface: JPEG decode on the card for
// ImageRecordIter's CUDA target, and the encoder chip_smoke.py writes its
// corpus with.  No kernel is written here: nvJPEG is the CUDA toolkit's
// library and this file only drives it (linked with -lnvjpeg).
//
// Replaces no TPU kernel.  It replaces the libjpeg decode inside
// src/recordio_native.cc decode_augment_batch (:157, DecodeJpeg :49) on a
// host without libjpeg: the decoded RGB uint8 HWC images feed
// csrc/image_augment.cu, which does the rest of that function.
//
// What the wrapper (io/nvjpeg.py) calls, per batch:
//   1. mxt_nvj_info per image: nvjpegGetImageInfo reads the header (size,
//      components, chroma subsampling) on the host.  An image that fails
//      it is quarantined by its record id, as the host path quarantines a
//      libjpeg failure.
//   2. mxt_nvj_decode_batched on the rest: one nvjpegDecodeBatched into
//      one device buffer, image i at offs[i], interleaved RGB (pitch
//      3 x width), on the caller's stream.  The handle is made with the
//      hardware backend where nvJPEG offers one (the A100/H100 JPEG
//      engines), else the GPU-hybrid CUDA backend (Huffman decoding on
//      the GPU for batches of more than 100 images), else the default
//      one.  The bitstreams come from pinned host memory.
//   3. If the batched call fails, mxt_nvj_decode_one image by image on
//      the default backend: the image that fails is named, never
//      zero-filled.
// Grayscale input decodes to RGB with the three channels equal, as
// libjpeg's JCS_RGB output gives it.
//
// Every function returns an nvjpegStatus_t (0 = success), or 100 + a
// cudaError_t for a CUDA runtime failure, or 200 for a size mismatch.
#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

#include <new>
#include <vector>

namespace {

struct Ctx {
  nvjpegHandle_t batched = nullptr;  // hardware backend where offered
  nvjpegHandle_t plain = nullptr;    // default backend
  nvjpegJpegState_t batched_state = nullptr;
  nvjpegJpegState_t plain_state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int batch_size = 0;
  int hardware = 0;
};

#define NVJ_TRY(x)                                   \
  do {                                               \
    nvjpegStatus_t s_ = (x);                         \
    if (s_ != NVJPEG_STATUS_SUCCESS) return (int)s_; \
  } while (0)

}  // namespace

extern "C" {

int mxt_nvj_create(void** out) {
  Ctx* c = new (std::nothrow) Ctx();
  if (c == nullptr) return (int)NVJPEG_STATUS_ALLOCATOR_FAILURE;
  nvjpegStatus_t s = nvjpegCreateSimple(&c->plain);
  if (s != NVJPEG_STATUS_SUCCESS) {
    delete c;
    return (int)s;
  }
  if (nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr, nullptr, 0,
                     &c->batched) == NVJPEG_STATUS_SUCCESS) {
    c->hardware = 1;
  } else if (nvjpegCreateEx(NVJPEG_BACKEND_GPU_HYBRID, nullptr, nullptr,
                            0, &c->batched) == NVJPEG_STATUS_SUCCESS) {
    c->hardware = 2;  // Huffman on the GPU for batches over 100 images
  } else {
    c->batched = c->plain;
  }
  s = nvjpegJpegStateCreate(c->plain, &c->plain_state);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegJpegStateCreate(c->batched, &c->batched_state);
  if (s != NVJPEG_STATUS_SUCCESS) return (int)s;
  *out = c;
  return 0;
}

// The batched handle's backend: 1 hardware, 2 GPU-hybrid, 0 default.
int mxt_nvj_hardware(void* h) { return static_cast<Ctx*>(h)->hardware; }

void mxt_nvj_destroy(void* h) {
  Ctx* c = static_cast<Ctx*>(h);
  if (c == nullptr) return;
  if (c->enc_params) nvjpegEncoderParamsDestroy(c->enc_params);
  if (c->enc_state) nvjpegEncoderStateDestroy(c->enc_state);
  if (c->batched_state) nvjpegJpegStateDestroy(c->batched_state);
  if (c->plain_state) nvjpegJpegStateDestroy(c->plain_state);
  if (c->batched != c->plain && c->batched) nvjpegDestroy(c->batched);
  if (c->plain) nvjpegDestroy(c->plain);
  delete c;
}

// Header pass: height, width (of the full image), components and chroma
// subsampling (nvjpegChromaSubsampling_t).
int mxt_nvj_info(void* h, const void* data, int64_t len, int* height,
                 int* width, int* ncomp, int* subsampling) {
  Ctx* c = static_cast<Ctx*>(h);
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t ss;
  NVJ_TRY(nvjpegGetImageInfo(c->plain,
                             static_cast<const unsigned char*>(data),
                             static_cast<size_t>(len), ncomp, &ss, widths,
                             heights));
  *height = heights[0];
  *width = widths[0];
  *subsampling = (int)ss;
  return 0;
}

// Batched decode of n images (host pointers datas[i], lengths lens[i]) to
// interleaved RGB in one device buffer: image i at out + offs[i], width
// widths[i].
int mxt_nvj_decode_batched(void* h, int n, const void* datas,
                           const void* lens, void* out, const void* offs,
                           const void* widths, void* stream) {
  Ctx* c = static_cast<Ctx*>(h);
  if (n <= 0) return 0;
  if (c->batch_size != n) {
    NVJ_TRY(nvjpegDecodeBatchedInitialize(c->batched, c->batched_state, n,
                                          1, NVJPEG_OUTPUT_RGBI));
    c->batch_size = n;
  }
  const int64_t* off = static_cast<const int64_t*>(offs);
  const int* w = static_cast<const int*>(widths);
  std::vector<nvjpegImage_t> dst(n);
  for (int i = 0; i < n; ++i) {
    for (int k = 0; k < NVJPEG_MAX_COMPONENT; ++k) {
      dst[i].channel[k] = nullptr;
      dst[i].pitch[k] = 0;
    }
    dst[i].channel[0] = static_cast<unsigned char*>(out) + off[i];
    dst[i].pitch[0] = static_cast<size_t>(w[i]) * 3;
  }
  NVJ_TRY(nvjpegDecodeBatched(
      c->batched, c->batched_state,
      static_cast<const unsigned char* const*>(datas),
      static_cast<const size_t*>(lens), dst.data(),
      static_cast<cudaStream_t>(stream)));
  return 0;
}

// One image on the default backend, to out (pitch 3 x width).
int mxt_nvj_decode_one(void* h, const void* data, int64_t len, void* out,
                       int width, void* stream) {
  Ctx* c = static_cast<Ctx*>(h);
  nvjpegImage_t dst;
  for (int k = 0; k < NVJPEG_MAX_COMPONENT; ++k) {
    dst.channel[k] = nullptr;
    dst.pitch[k] = 0;
  }
  dst.channel[0] = static_cast<unsigned char*>(out);
  dst.pitch[0] = static_cast<size_t>(width) * 3;
  NVJ_TRY(nvjpegDecode(c->plain, c->plain_state,
                       static_cast<const unsigned char*>(data),
                       static_cast<size_t>(len), NVJPEG_OUTPUT_RGBI, &dst,
                       static_cast<cudaStream_t>(stream)));
  return 0;
}

// Encode one interleaved RGB uint8 image on the card (pitch 3 x width) to
// a JPEG in host memory: out holds *len bytes on entry; on return *len is
// the JPEG's size (200 when it does not fit, with *len the size needed).
// Synchronises the stream: the corpus writer is not a hot path.
int mxt_nvj_encode(void* h, const void* rgb, int width, int height,
                   int quality, int subsampling, void* out, int64_t* len,
                   void* stream) {
  Ctx* c = static_cast<Ctx*>(h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c->enc_state == nullptr) {
    NVJ_TRY(nvjpegEncoderStateCreate(c->plain, &c->enc_state, st));
    NVJ_TRY(nvjpegEncoderParamsCreate(c->plain, &c->enc_params, st));
  }
  NVJ_TRY(nvjpegEncoderParamsSetQuality(c->enc_params, quality, st));
  NVJ_TRY(nvjpegEncoderParamsSetSamplingFactors(
      c->enc_params, (nvjpegChromaSubsampling_t)subsampling, st));
  nvjpegImage_t src;
  for (int k = 0; k < NVJPEG_MAX_COMPONENT; ++k) {
    src.channel[k] = nullptr;
    src.pitch[k] = 0;
  }
  src.channel[0] = static_cast<unsigned char*>(const_cast<void*>(rgb));
  src.pitch[0] = static_cast<size_t>(width) * 3;
  NVJ_TRY(nvjpegEncodeImage(c->plain, c->enc_state, c->enc_params, &src,
                            NVJPEG_INPUT_RGBI, width, height, st));
  size_t n = 0;
  NVJ_TRY(nvjpegEncodeRetrieveBitstream(c->plain, c->enc_state, nullptr,
                                        &n, st));
  cudaError_t e = cudaStreamSynchronize(st);
  if (e != cudaSuccess) return 100 + (int)e;
  if (static_cast<int64_t>(n) > *len) {
    *len = static_cast<int64_t>(n);
    return 200;
  }
  NVJ_TRY(nvjpegEncodeRetrieveBitstream(
      c->plain, c->enc_state, static_cast<unsigned char*>(out), &n, st));
  e = cudaStreamSynchronize(st);
  if (e != cudaSuccess) return 100 + (int)e;
  *len = static_cast<int64_t>(n);
  return 0;
}

}  // extern "C"
