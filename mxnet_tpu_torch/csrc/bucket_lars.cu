// Two-phase LARS update of one flat bucket for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels mxnet_tpu/ops/pallas_opt.py:
// _lars_norms_kernel (phase A) and _lars_update_kernel (phase B), with the
// jnp trust-ratio math between them (_lars_bucket), and computes what they
// compute over one flat fp32 bucket of n elements whose element i belongs to
// tensor seg[i] of the bucket (nseg <= 128 segments):
//
//   (a) lars_norms_kernel:  per-CTA partials of w_ss[s] = sum w^2 and
//       g_ss[s] = sum gp^2 over the elements of segment s, gp = clip(g *
//       rescale) in fp32, plus the CTA's count of non-finite raw g;
//   (b) lars_trust_kernel:  one CTA per segment reduces the partials in a
//       fixed order, then trust = eta*|w| / (|g| + wd*|w| + eps) where both
//       norms are positive (else 1) and slr[s] = lr * trust; CTA 0 also sums
//       the non-finite counts.  A bucket sharded over processes splits (b):
//       the same reduce without the trust (this shard's sums and count),
//       which the caller sums over the processes (the reference's psum
//       between its norms kernel and its trust math), then
//       lars_trust_sums_kernel takes the trust from the summed norms;
//   (c) lars_update_kernel: mom = momentum*m + slr[seg]*(gp + wd*w);
//       w' = w - mom, m' = mom (_lars_bucket_step, that order).
//
// The TPU carried its sums across a sequential grid in VMEM.  Hopper's grid
// runs in parallel, so (a) leaves one partial per CTA and (b) reduces them:
// no float atomics anywhere, so two runs give the same bits.  Inside (a) each
// warp takes 32 consecutive elements at a time.  When the 32 share one
// segment (the common case: a tensor spans many warps' worth), a shuffle tree
// sums them; otherwise the lanes of each segment (__match_any_sync) are summed
// in lane order by their lowest lane.  Either way one lane adds the sum to its
// warp's per-segment accumulator in shared memory, and at the end the CTA sums
// its 8 warps' accumulators in order.  Segment ids may be any int32; an id
// outside [0, nseg) adds to no norm and gets slr 0, as in the TPU kernels.
//
// (c) rounds every operation on its own (__fmul_rn, __fadd_rn, __fsub_rn) in
// the plain PyTorch version's order, so given the same slr it is bit-identical
// to it.  The norms are sums in another order than the plain version's
// index_add_, so the whole update agrees with it to rounding.
//
// What bounds it on an H100: bytes.  (a) reads w, g, seg (12 bytes an
// element), (c) reads w, g, m, seg and writes w', m' (24): 36 bytes an element,
// about 0.025 ms for ResNet-50's largest bucket (2,359,296 elements) at
// 3.35 TB/s.  (b) moves a few hundred KB at most.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSeg = 128;
constexpr int kMaxNormBlocks = 132 * 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float prep(float graw, float rescale, float clip,
                                      int has_clip) {
  float gp = __fmul_rn(graw, rescale);
  if (has_clip && gp == gp) gp = fminf(fmaxf(gp, -clip), clip);
  return gp;
}

template <bool kFinite>
__global__ void __launch_bounds__(kThreads)
lars_norms_kernel(const float* __restrict__ w, const float* __restrict__ g,
                  const int* __restrict__ seg, float* __restrict__ part,
                  int* __restrict__ part_nf, int64_t n, int nseg,
                  float rescale, float clip, int has_clip) {
  __shared__ float acc[2][kWarps][kMaxSeg];
  __shared__ float buf[2][kWarps][32];
  __shared__ int warp_bad[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int k = threadIdx.x; k < 2 * kWarps * kMaxSeg; k += kThreads)
    (&acc[0][0][0])[k] = 0.f;
  __syncthreads();
  int bad = 0;
  const int64_t tiles = (n + 31) / 32;
  for (int64_t tile = (int64_t)blockIdx.x * kWarps + warp; tile < tiles;
       tile += (int64_t)gridDim.x * kWarps) {
    const int64_t i = tile * 32 + lane;
    int id = -1;
    float ww = 0.f, gg = 0.f;
    if (i < n) {
      const float graw = g[i];
      if (kFinite) bad += isfinite(graw) ? 0 : 1;
      const float gp = prep(graw, rescale, clip, has_clip);
      const float wv = w[i];
      ww = __fmul_rn(wv, wv);
      gg = __fmul_rn(gp, gp);
      id = seg[i];
      if (id < 0 || id >= nseg) id = -1;
    }
    const unsigned peers = __match_any_sync(kFull, id);
    if (peers == kFull) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ww = __fadd_rn(ww, __shfl_xor_sync(kFull, ww, off));
        gg = __fadd_rn(gg, __shfl_xor_sync(kFull, gg, off));
      }
      if (lane == 0 && id >= 0) {
        acc[0][warp][id] = __fadd_rn(acc[0][warp][id], ww);
        acc[1][warp][id] = __fadd_rn(acc[1][warp][id], gg);
      }
    } else {
      buf[0][warp][lane] = ww;
      buf[1][warp][lane] = gg;
      __syncwarp();
      if (id >= 0 && lane == __ffs(peers) - 1) {
        float sw = 0.f, sg = 0.f;
        for (unsigned rest = peers; rest; rest &= rest - 1) {
          const int l = __ffs(rest) - 1;
          sw = __fadd_rn(sw, buf[0][warp][l]);
          sg = __fadd_rn(sg, buf[1][warp][l]);
        }
        acc[0][warp][id] = __fadd_rn(acc[0][warp][id], sw);
        acc[1][warp][id] = __fadd_rn(acc[1][warp][id], sg);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  const int64_t nblk = gridDim.x;
  for (int s = threadIdx.x; s < nseg; s += kThreads) {
    float sw = 0.f, sg = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      sw = __fadd_rn(sw, acc[0][k][s]);
      sg = __fadd_rn(sg, acc[1][k][s]);
    }
    part[(int64_t)blockIdx.x * nseg + s] = sw;
    part[(nblk + blockIdx.x) * nseg + s] = sg;
  }
  if (kFinite) {
    bad = __reduce_add_sync(kFull, bad);
    if (lane == 0) warp_bad[warp] = bad;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) total += warp_bad[k];
      part_nf[blockIdx.x] = total;
    }
  }
}

__device__ __forceinline__ float scaled_lr(float w_ss, float g_ss, float lr,
                                           float wd, float eta, float eps) {
  const float w_norm = __fsqrt_rn(w_ss), g_norm = __fsqrt_rn(g_ss);
  float trust = 1.f;
  if (w_norm > 0.f && g_norm > 0.f)
    trust = __fdiv_rn(__fmul_rn(eta, w_norm),
                      __fadd_rn(__fadd_rn(g_norm, __fmul_rn(wd, w_norm)),
                                eps));
  return __fmul_rn(lr, trust);
}

// One CTA per segment: thread t sums partials t, t + 256, ... in order, then
// a fixed shared-memory tree.  Segment 0's CTA also sums the counts.  kTrust:
// the trust ratios and the int count; else the sums alone, with the count as
// a float after them in sq (exact below 2^24), for the caller to sum.
template <bool kTrust>
__global__ void __launch_bounds__(kThreads)
lars_trust_kernel(const float* __restrict__ part,
                  const int* __restrict__ part_nf, float* __restrict__ sq,
                  float* __restrict__ slr, int* __restrict__ nf, int blocks,
                  int nseg, int with_finite, float lr, float wd, float eta,
                  float eps) {
  __shared__ float red[2][kThreads];
  __shared__ int red_nf[kThreads];
  const int s = blockIdx.x, t = threadIdx.x;
  float sw = 0.f, sg = 0.f;
  int cnt = 0;
  for (int p = t; p < blocks; p += kThreads) {
    sw = __fadd_rn(sw, part[(int64_t)p * nseg + s]);
    sg = __fadd_rn(sg, part[((int64_t)blocks + p) * nseg + s]);
    if (with_finite && s == 0) cnt += part_nf[p];
  }
  red[0][t] = sw;
  red[1][t] = sg;
  red_nf[t] = cnt;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (t < half) {
      red[0][t] = __fadd_rn(red[0][t], red[0][t + half]);
      red[1][t] = __fadd_rn(red[1][t], red[1][t + half]);
      red_nf[t] += red_nf[t + half];
    }
    __syncthreads();
  }
  if (t == 0) {
    const float w_ss = red[0][0], g_ss = red[1][0];
    sq[s] = w_ss;
    sq[nseg + s] = g_ss;
    if (kTrust) {
      slr[s] = scaled_lr(w_ss, g_ss, lr, wd, eta, eps);
      if (with_finite && s == 0) *nf = red_nf[0];
    } else if (with_finite && s == 0) {
      sq[2 * nseg] = (float)red_nf[0];
    }
  }
}

// The trust ratios from norms summed over the shards: sums holds w_ss, g_ss
// (nseg each) and, with with_finite, the non-finite count as a float.
__global__ void __launch_bounds__(kMaxSeg)
lars_trust_sums_kernel(const float* __restrict__ sums, float* __restrict__ slr,
                       int* __restrict__ nf, int nseg, int with_finite,
                       float lr, float wd, float eta, float eps) {
  for (int s = threadIdx.x; s < nseg; s += blockDim.x)
    slr[s] = scaled_lr(sums[s], sums[nseg + s], lr, wd, eta, eps);
  if (with_finite && threadIdx.x == 0) *nf = (int)sums[2 * nseg];
}

__global__ void __launch_bounds__(kThreads)
lars_update_kernel(const float* w, const float* __restrict__ g,
                   const float* m, const int* __restrict__ seg,
                   const float* __restrict__ slr, float* ow, float* om,
                   int64_t n, int nseg, float wd, float momentum,
                   float rescale, float clip, int has_clip) {
  __shared__ float s_slr[kMaxSeg];
  for (int s = threadIdx.x; s < nseg; s += kThreads) s_slr[s] = slr[s];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int id = seg[i];
    const float r = (id >= 0 && id < nseg) ? s_slr[id] : 0.f;
    const float gp = prep(g[i], rescale, clip, has_clip);
    const float wv = w[i];
    const float mom = __fadd_rn(__fmul_rn(momentum, m[i]),
                                __fmul_rn(r, __fadd_rn(gp, __fmul_rn(wd, wv))));
    ow[i] = __fsub_rn(wv, mom);
    om[i] = mom;
  }
}

int norm_blocks(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return (int)(want < kMaxNormBlocks ? want : kMaxNormBlocks);
}

}  // namespace

// C interface, loaded with ctypes.  Each launcher returns the cudaError_t of
// its launch (0 = launched).

// CTAs of phase (a) for n elements: the caller sizes part (2 x blocks x nseg
// floats) and part_nf (blocks ints) with it.
extern "C" int mxt_lars_norm_blocks(long long n) {
  return n > 0 ? norm_blocks(n) : 0;
}

extern "C" int mxt_lars_norms(const float* w, const float* g, const int* seg,
                              float* part, int* part_nf, long long n, int nseg,
                              int with_finite, float rescale, float clip,
                              int has_clip, int blocks, void* stream) {
  if (n <= 0 || nseg < 1 || nseg > kMaxSeg || blocks != norm_blocks(n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_finite)
    lars_norms_kernel<true><<<blocks, kThreads, 0, st>>>(
        w, g, seg, part, part_nf, n, nseg, rescale, clip, has_clip);
  else
    lars_norms_kernel<false><<<blocks, kThreads, 0, st>>>(
        w, g, seg, part, part_nf, n, nseg, rescale, clip, has_clip);
  return (int)cudaGetLastError();
}

// sq: 2 x nseg floats (w_ss, then g_ss); slr: nseg floats; nf: one int,
// written when with_finite.
extern "C" int mxt_lars_trust(const float* part, const int* part_nf,
                              float* sq, float* slr, int* nf, int blocks,
                              int nseg, int with_finite, float lr, float wd,
                              float eta, float eps, void* stream) {
  if (blocks < 1 || nseg < 1 || nseg > kMaxSeg)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lars_trust_kernel<true><<<nseg, kThreads, 0, st>>>(
      part, part_nf, sq, slr, nf, blocks, nseg, with_finite, lr, wd, eta,
      eps);
  return (int)cudaGetLastError();
}

// The split (b) of a sharded bucket, first half: sums gets this shard's
// w_ss, g_ss (nseg floats each) and, with with_finite, its non-finite count
// as one float after them (2 * nseg + 1 floats).
extern "C" int mxt_lars_reduce(const float* part, const int* part_nf,
                               float* sums, int blocks, int nseg,
                               int with_finite, void* stream) {
  if (blocks < 1 || nseg < 1 || nseg > kMaxSeg)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lars_trust_kernel<false><<<nseg, kThreads, 0, st>>>(
      part, part_nf, sums, nullptr, nullptr, blocks, nseg, with_finite, 0.f,
      0.f, 0.f, 0.f);
  return (int)cudaGetLastError();
}

// Second half: slr (nseg floats) from the summed sums; nf (one int) the
// summed count, written when with_finite.
extern "C" int mxt_lars_trust_sums(const float* sums, float* slr, int* nf,
                                   int nseg, int with_finite, float lr,
                                   float wd, float eta, float eps,
                                   void* stream) {
  if (nseg < 1 || nseg > kMaxSeg) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lars_trust_sums_kernel<<<1, kMaxSeg, 0, st>>>(sums, slr, nf, nseg,
                                                with_finite, lr, wd, eta, eps);
  return (int)cudaGetLastError();
}

// ow / om may alias w / m for an in-place update.
extern "C" int mxt_lars_update(const float* w, const float* g, const float* m,
                               const int* seg, const float* slr, float* ow,
                               float* om, long long n, int nseg, float wd,
                               float momentum, float rescale, float clip,
                               int has_clip, void* stream) {
  if (n <= 0 || nseg < 1 || nseg > kMaxSeg) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  lars_update_kernel<<<blocks, kThreads, 0, st>>>(
      w, g, m, seg, slr, ow, om, n, nseg, wd, momentum, rescale, clip,
      has_clip);
  return (int)cudaGetLastError();
}
