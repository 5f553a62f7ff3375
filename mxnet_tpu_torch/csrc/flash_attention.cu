// Flash-attention forward for Hopper (sm_90a), CUDA C++, on the tensor cores.
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
// Layout: q (BH, Sq, D), k/v (BH, Sk, D), contiguous and 16-byte aligned,
// fp32 or bf16; output in q's dtype; softmax and accumulators in fp32.  D is
// a template parameter over {8, 16, 32, 64, 128}; a D that is a multiple of
// 128 above it runs flash_fwd_slab_kernel, which has the D = 128 kernel's
// registers and shared memory (128-wide slabs of O, S summed over 128-deep
// chunks; see there).
//
// What bounds it on an H100: at D = 128 and long sequences, operations,
// 4 * BH * pairs * D FLOPs over the visible (query, key) pairs.  bf16 runs
// them once on the tensor cores (989 TFLOP/s dense).  fp32 must keep fp32
// accuracy: one TF32 pass is 1e-3 off, so every product is split TF32,
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a*b is taken as
// lo_a*hi_b + hi_a*lo_b + hi_a*hi_b: three TF32 MMAs (495 TFLOP/s dense), so
// the fp32 bound is 3 x FLOPs / 495e12.  At the generative server's bench
// width (D = 8, Sq <= 16) the work is tiny and the launch is the time.
//
// Design (FlashAttention-2 on mma.sync):
// - A CTA of kWarps warps owns 16 * kMT * kWarps query rows, kMT m-tiles
//   of 16 rows per warp (fp32: 8 warps x 1, bf16: 4 warps x 2, so that a
//   bf16 K or V fragment serves 32 rows).  The Q tile is loaded once;
//   key/value tiles of kBK keys stream through a ring of kStages stages in
//   dynamic shared memory, filled by 16-byte cp.async.cg copies with
//   commit/wait groups, so the next tile loads while this one is
//   multiplied.  Rows past Sq or Sk are zero-filled; m-tiles wholly past
//   Sq skip the math.
// - S = Q K^T and O += P V are mma.sync: m16n8k8 TF32 (three passes, the
//   operands split as fragments are read from fp32 shared memory) or
//   m16n8k16 bf16 (one pass, fragments by ldmatrix; D = 8 is padded to a
//   depth of 16 with zeros for Q K^T).  fp32 rows are padded by 4 words and
//   bf16 rows by 16 bytes, so that fragment reads hit 32 distinct banks.
// - The online softmax runs in registers on the S accumulators: row max by
//   quad shuffles, exp2f with sm_scale * log2(e) folded in, the
//   reference's -inf guards.  P is the A operand of P V without a trip
//   through shared memory: for bf16 the C fragment is the A fragment; for
//   TF32 the 8 keys of a k-step are taken in the order (0, 2, 4, 6, 1, 3,
//   5, 7), which makes the C fragment the A fragment too, and V's rows are
//   read in the same order.
// - Work items come from the wrapper's plan: (q tile, key tiles [kt0, kt1),
//   slot), heaviest first.  When BH * q tiles would leave SMs idle (a few
//   queries against a long cache) the plan splits a q tile's key range
//   over several items, each writes its (m, l, acc) partial to scratch,
//   and flash_combine_kernel merges them in a fixed order: the result is
//   deterministic and a fully masked row stays exactly 0.
// wgmma/TMA are not used: TF32 wgmma wants K-major B operands in shared
// memory, which V's tile (keys x D, D contiguous) is not.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
// the widest tile depth; deeper heads run in slabs of this width
constexpr int kSlab = 128;

// Tile configuration per dtype: warps per CTA, 16-row m-tiles per warp,
// keys per tile, ring stages (the fastest of the configurations timed on
// the card, PERF.md).
template <typename T, int D>
struct Cfg;
template <int D>
struct Cfg<float, D> {
  static constexpr int kWarps = 8;
  static constexpr int kMT = 1;  // 16-row m-tiles a warp
  static constexpr int kBK = 64;
  static constexpr int kStages = 2;
  static constexpr int kDK = D;         // depth of the Q K^T product
  static constexpr int kPitch = D + 4;  // row pitch in shared memory
};
template <int D>
struct Cfg<__nv_bfloat16, D> {
  static constexpr int kWarps = 4;
  static constexpr int kMT = 2;
  static constexpr int kBK = 64;
  static constexpr int kStages = 2;
  static constexpr int kDK = D < 16 ? 16 : D;
  static constexpr int kPitch = kDK + 8;
};

template <typename T, int D>
struct Tiles {
  using C = Cfg<T, D>;
  static constexpr int kThreads = 32 * C::kWarps;
  static constexpr int kBQ = 16 * C::kMT * C::kWarps;
  static constexpr int kTile = C::kBK * C::kPitch;  // elements of K or V
  static constexpr size_t kSmem =
      sizeof(T) * ((size_t)kBQ * C::kPitch + 2 * C::kStages * kTile);
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// the split product, small terms first
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4],
                                           const uint32_t al[4],
                                           const uint32_t bh[2],
                                           const uint32_t bl[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t r[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// D columns of rows [row0, row0 + n_rows) of a matrix whose rows are `ld`
// elements apart into shared memory of pitch P; rows at or past `limit` are
// zero-filled
template <typename T, int D, int P, int kThreads>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int n_rows, int limit, int ld) {
  constexpr int kChunks = D * (int)sizeof(T) / 16;  // per row
  for (int idx = threadIdx.x; idx < n_rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = row0 + r < limit;
    const T* from = ok ? src + (int64_t)(row0 + r) * ld + c * (16 / sizeof(T))
                       : src;
    cp_async16(dst + r * P + c * (16 / sizeof(T)), from, ok ? 16 : 0);
  }
}

// ------------------------------------------------------------- the kernel
// The S accumulator tiles of one key tile: kMT m-tiles x kBK / 8 keys.
template <typename T, int D>
using STile = float[Cfg<T, D>::kMT][Cfg<T, D>::kBK / 8][4];

// s += Q K^T over one kDK-deep chunk, for the first A of this warp's kMT
// m-tiles (16 rows each; A < kMT when the rest of the warp's rows lie past
// Sq).  q_w and ks have pitch kPitch.  Every K fragment read from shared
// memory (and, for TF32, split) is used by all A m-tiles.
template <typename T, int D, int A>
__device__ __forceinline__ void qk_product(const T* __restrict__ q_w,
                                           const T* __restrict__ ks,
                                           STile<T, D>& s) {
  using C = Cfg<T, D>;
  constexpr int P = C::kPitch;
  constexpr int NT = C::kBK / 8;  // S accumulator tiles (8 keys each)
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  if constexpr (sizeof(T) == 4) {
    const float* qr = reinterpret_cast<const float*>(q_w) + g * P + t;
    const float* kr = reinterpret_cast<const float*>(ks) + g * P + t;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[A][4], al[A][4];
#pragma unroll
      for (int mt = 0; mt < A; ++mt) {
        const float* qm = qr + mt * 16 * P + kk * 8;
        split_tf32(qm[0], ah[mt][0], al[mt][0]);
        split_tf32(qm[8 * P], ah[mt][1], al[mt][1]);
        split_tf32(qm[4], ah[mt][2], al[mt][2]);
        split_tf32(qm[8 * P + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh[2], bl[2];
        split_tf32(kr[j * 8 * P + kk * 8], bh[0], bl[0]);
        split_tf32(kr[j * 8 * P + kk * 8 + 4], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < A; ++mt)
          mma_3xtf32(s[mt][j], ah[mt], al[mt], bh, bl);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < C::kDK / 16; ++kk) {
      uint32_t a[A][4];
#pragma unroll
      for (int mt = 0; mt < A; ++mt)
        ldmatrix_x4(a[mt], q_w + (mt * 16 + ((lane >> 3) & 1) * 8 +
                                  (lane & 7)) * P +
                               kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (8 * (j + (lane >> 4)) + (lane & 7)) * P +
                           kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < A; ++mt) {
          mma_bf16(s[mt][j], a[mt], b[0], b[1]);
          mma_bf16(s[mt][j + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

// The rest of one key tile for the first A m-tiles, once S = Q K^T is in
// s: the online softmax, then O += P V with V's tile vs (pitch kPitch, D
// columns).  Every V fragment is used by all A m-tiles.
template <typename T, int D, int A>
__device__ __forceinline__ void softmax_pv(
    STile<T, D>& s, const T* __restrict__ vs, int k0, int rw, int sk,
    int diag, int causal, float scale_log2,
    float (&acc)[Cfg<T, D>::kMT][D / 8][4], float (&mrow)[Cfg<T, D>::kMT][2],
    float (&lrow)[Cfg<T, D>::kMT][2]) {
  using C = Cfg<T, D>;
  constexpr int P = C::kPitch;
  constexpr int BK = C::kBK;
  constexpr int NT = BK / 8;  // S accumulator tiles (8 keys each)
  constexpr int NO = D / 8;   // O accumulator tiles (8 columns each)
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group

  // ---- online softmax on the accumulators (exp2 domain)
#pragma unroll
  for (int mt = 0; mt < A; ++mt) {
    const int r0 = rw + mt * 16;  // this m-tile's first row
    const bool need_mask =
        k0 + BK > sk || (causal && k0 + BK - 1 > r0 + diag);
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[mt][j][e] * scale_log2;
        if (need_mask) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = r0 + g + (e >> 1) * 8;
          if (key >= sk || (causal && key > row + diag)) x = -CUDART_INF_F;
        }
        s[mt][j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[mt][j][0], s[mt][j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[mt][j][2], s[mt][j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // the -inf guards of the reference: a row with nothing seen keeps
    // m = -inf, and -inf - -inf is never formed
    const float n0 = fmaxf(mrow[mt][0], mx0), n1 = fmaxf(mrow[mt][1], mx1);
    const float b0 = n0 == -CUDART_INF_F ? 0.f : n0;
    const float b1 = n1 == -CUDART_INF_F ? 0.f : n1;
    const float alpha0 = exp2f(mrow[mt][0] - b0);
    const float alpha1 = exp2f(mrow[mt][1] - b1);
    mrow[mt][0] = n0;
    mrow[mt][1] = n1;
    lrow[mt][0] *= alpha0;
    lrow[mt][1] *= alpha1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[mt][n][0] *= alpha0;
      acc[mt][n][1] *= alpha0;
      acc[mt][n][2] *= alpha1;
      acc[mt][n][3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[mt][j][0] = exp2f(s[mt][j][0] - b0);
      s[mt][j][1] = exp2f(s[mt][j][1] - b0);
      s[mt][j][2] = exp2f(s[mt][j][2] - b1);
      s[mt][j][3] = exp2f(s[mt][j][3] - b1);
      lrow[mt][0] += s[mt][j][0] + s[mt][j][1];
      lrow[mt][1] += s[mt][j][2] + s[mt][j][3];
    }
  }

  // ---- O += P V
  if constexpr (sizeof(T) == 4) {
    // k-step j takes keys 8j + (0, 2, 4, 6, 1, 3, 5, 7): A's column t is
    // key 2t (c0, c2) and column t + 4 key 2t + 1 (c1, c3)
    const float* vr = reinterpret_cast<const float*>(vs) + 2 * t * P + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[A][4], al[A][4];
#pragma unroll
      for (int mt = 0; mt < A; ++mt) {
        split_tf32(s[mt][j][0], ah[mt][0], al[mt][0]);
        split_tf32(s[mt][j][2], ah[mt][1], al[mt][1]);
        split_tf32(s[mt][j][1], ah[mt][2], al[mt][2]);
        split_tf32(s[mt][j][3], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bh[2], bl[2];
        split_tf32(vr[j * 8 * P + n * 8], bh[0], bl[0]);
        split_tf32(vr[(j * 8 + 1) * P + n * 8], bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < A; ++mt)
          mma_3xtf32(acc[mt][n], ah[mt], al[mt], bh, bl);
      }
    }
  } else {
#pragma unroll
    for (int kp = 0; kp < NT / 2; ++kp) {  // 16 keys a k-step
      uint32_t a[A][4];
#pragma unroll
      for (int mt = 0; mt < A; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kp][0], s[mt][2 * kp][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kp][2], s[mt][2 * kp][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kp + 1][0], s[mt][2 * kp + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kp + 1][2], s[mt][2 * kp + 1][3]);
      }
      const T* vrow =
          vs + (16 * kp + ((lane >> 3) & 1) * 8 + (lane & 7)) * P;
      if constexpr (NO % 2 == 0) {
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + 8 * (n + (lane >> 4)));
#pragma unroll
          for (int mt = 0; mt < A; ++mt) {
            mma_bf16(acc[mt][n], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][n + 1], a[mt], b[2], b[3]);
          }
        }
      } else {
        uint32_t b[2];
        ldmatrix_x2_trans(b, vrow);
#pragma unroll
        for (int mt = 0; mt < A; ++mt) mma_bf16(acc[mt][0], a[mt], b[0], b[1]);
      }
    }
  }
}

// One key tile of a D <= 128 kernel (Q and K each one chunk deep).
template <typename T, int D, int A>
__device__ __forceinline__ void tile_step(
    const T* __restrict__ q_w, const T* __restrict__ ks,
    const T* __restrict__ vs, int k0, int rw, int sk, int diag, int causal,
    float scale_log2, float (&acc)[Cfg<T, D>::kMT][D / 8][4],
    float (&mrow)[Cfg<T, D>::kMT][2], float (&lrow)[Cfg<T, D>::kMT][2]) {
  STile<T, D> s;
#pragma unroll
  for (int mt = 0; mt < A; ++mt)
#pragma unroll
    for (int j = 0; j < Cfg<T, D>::kBK / 8; ++j)
      s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
  qk_product<T, D, A>(q_w, ks, s);
  softmax_pv<T, D, A>(s, vs, k0, rw, sk, diag, causal, scale_log2, acc, mrow,
                      lrow);
}

// The epilogue of one CTA: its q tile's rows of O (columns [col0, col0 + D)
// of rows `ld` elements apart), normalised, or with `part` the (m, l, acc)
// partial of its key range in scratch slot `slot` (acc rows `ld` wide; m
// and l written only where `write_ml`, by one CTA of the q tile).
template <typename T, int D>
__device__ __forceinline__ void write_result(
    float (&acc)[Cfg<T, D>::kMT][D / 8][4], float (&mrow)[Cfg<T, D>::kMT][2],
    float (&lrow)[Cfg<T, D>::kMT][2], T* __restrict__ o,
    float* __restrict__ part, int slot, int bh, int q0, int sq, int ld,
    int col0, bool write_ml, int n_slots) {
  using C = Cfg<T, D>;
  constexpr int BQ = Tiles<T, D>::kBQ;
  constexpr int MT = C::kMT;
  constexpr int NO = D / 8;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = lrow[mt][0], l1 = lrow[mt][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const int r0 = warp * 16 * MT + mt * 16 + g;  // row within the tile
    const bool ok0 = q0 + r0 < sq, ok1 = q0 + r0 + 8 < sq;
    if (part == nullptr) {
      const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
      T* ob = o + (int64_t)bh * sq * ld + col0;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (ok0)
          store2(ob + (int64_t)(q0 + r0) * ld + 8 * n + 2 * t,
                 acc[mt][n][0] / d0, acc[mt][n][1] / d0);
        if (ok1)
          store2(ob + (int64_t)(q0 + r0 + 8) * ld + 8 * n + 2 * t,
                 acc[mt][n][2] / d1, acc[mt][n][3] / d1);
      }
    } else {
      float* pb = part + ((int64_t)bh * n_slots + slot) * BQ * (ld + 2);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (ok0)
          store2(pb + r0 * ld + col0 + 8 * n + 2 * t, acc[mt][n][0],
                 acc[mt][n][1]);
        if (ok1)
          store2(pb + (r0 + 8) * ld + col0 + 8 * n + 2 * t, acc[mt][n][2],
                 acc[mt][n][3]);
      }
      if (t == 0 && write_ml) {
        pb[BQ * ld + r0] = mrow[mt][0];
        pb[BQ * ld + r0 + 8] = mrow[mt][1];
        pb[BQ * ld + BQ + r0] = l0;
        pb[BQ * ld + BQ + r0 + 8] = l1;
      }
    }
  }
}

// One CTA per (work item, batch*head): blockIdx.x = item * bh_count + bh,
// items heaviest first.  item = (q tile, first key tile, end key tile,
// scratch slot).  part == nullptr: write the normalised output; else write
// the (m, l, acc) partial of this key range to slot `item.w`.
template <typename T, int D>
__global__ void __launch_bounds__(Tiles<T, D>::kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ part, const int4* __restrict__ items,
                 int bh_count, int sq, int sk, int causal, float scale_log2,
                 int n_slots) {
  using C = Cfg<T, D>;
  using X = Tiles<T, D>;
  constexpr int P = C::kPitch;
  constexpr int BK = C::kBK;
  constexpr int BQ = X::kBQ;
  constexpr int MT = C::kMT;
  constexpr int NO = D / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* kv_s = q_s + BQ * P;  // stage s: K at kv_s + 2 s tile, V after it

  const int4 item = items[blockIdx.x / bh_count];
  const int bh = blockIdx.x % bh_count;
  const int q0 = item.x * BQ;
  const int kt0 = item.y;
  const int n_tiles = item.z - item.y;
  const int warp = threadIdx.x / 32;
  const int qw = q0 + warp * 16 * MT;  // this warp's first row
  const int diag = sk - sq;            // bottom-right causal alignment
  // m-tiles of this warp with a row before Sq
  const int active = min(MT, max(0, (sq - qw + 15) / 16));

  const T* qb = q + (int64_t)bh * sq * D;
  const T* kb = k + (int64_t)bh * sk * D;
  const T* vb = v + (int64_t)bh * sk * D;

  if constexpr (C::kDK > D) {  // zero the depth padding once: cp.async
    // never writes it
    for (int idx = threadIdx.x; idx < (BQ + C::kStages * BK) * C::kDK;
         idx += X::kThreads) {
      const int r = idx / C::kDK, c = idx % C::kDK;
      if (c < D) continue;
      T* row = r < BQ ? q_s + r * P
                      : kv_s + ((r - BQ) / BK) * 2 * X::kTile +
                            ((r - BQ) % BK) * P;
      row[c] = T(0.f);
    }
  }

  auto load_tile = [&](int i) {  // key tile kt0 + i into stage i % kStages
    T* ks = kv_s + (i % C::kStages) * 2 * X::kTile;
    const int k0 = (kt0 + i) * BK;
    load_rows<T, D, P, X::kThreads>(ks, kb, k0, BK, sk, D);
    load_rows<T, D, P, X::kThreads>(ks + X::kTile, vb, k0, BK, sk, D);
  };

  if (n_tiles > 0) {
    load_rows<T, D, P, X::kThreads>(q_s, qb, q0, BQ, sq, D);
    load_tile(0);
    cp_async_commit();
#pragma unroll
    for (int i = 1; i < C::kStages - 1; ++i) {
      if (i < n_tiles) load_tile(i);
      cp_async_commit();
    }
  }

  float acc[MT][NO][4];
  float mrow[MT][2], lrow[MT][2];  // rows g and g + 8 of each m-tile;
  // lrow holds this thread's share of the row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    mrow[mt][0] = mrow[mt][1] = -CUDART_INF_F;
    lrow[mt][0] = lrow[mt][1] = 0.f;
  }
  const T* q_w = q_s + warp * 16 * MT * P;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i + C::kStages - 1 < n_tiles) load_tile(i + C::kStages - 1);
    cp_async_commit();
    const T* ks = kv_s + (i % C::kStages) * 2 * X::kTile;
    const int k0 = (kt0 + i) * BK;
    if (active == MT)
      tile_step<T, D, MT>(q_w, ks, ks + X::kTile, k0, qw, sk, diag, causal,
                          scale_log2, acc, mrow, lrow);
    else if (MT > 1 && active > 0)  // rows past Sq: nothing to compute
      tile_step<T, D, 1>(q_w, ks, ks + X::kTile, k0, qw, sk, diag, causal,
                         scale_log2, acc, mrow, lrow);
  }

  write_result<T, D>(acc, mrow, lrow, o, part, item.w, bh, q0, sq, D, 0,
                     true, n_slots);
}

// Head dims above 128 (depth = n_chunks * 128): one CTA per (work item,
// batch*head) in blockIdx.x, as above, and per 128-wide slab of V and O in
// blockIdx.y.  The registers and shared memory are those of the D = 128
// kernel: the accumulator is acc[kMT][16][4], and S = Q K^T is summed over
// 128-deep chunks of Q and K.  Each key tile is n_chunks + 1 steps through
// the same cp.async ring: step c < n_chunks brings chunk c of the Q tile
// and of the K tile (BQ + BK rows of a stage) and adds its product to S;
// the last brings the K tile's rows of this slab of V (BK rows) and runs
// the online softmax and O += P V.  Every slab's CTA sums S in the same
// order, so m and l agree bit for bit across slabs; slab 0 alone writes
// them to a key-split partial.  Q K^T is recomputed once per slab: at a
// depth of 256 the FLOPs are 1.5 x the ideal 4 * pairs * depth.
template <typename T>
__global__ void __launch_bounds__(Tiles<T, 128>::kThreads, 1)
flash_fwd_slab_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ part,
                      const int4* __restrict__ items, int bh_count, int sq,
                      int sk, int causal, float scale_log2, int n_slots,
                      int depth) {
  constexpr int D = kSlab;
  using C = Cfg<T, D>;
  using X = Tiles<T, D>;
  constexpr int P = C::kPitch;
  constexpr int BK = C::kBK;
  constexpr int BQ = X::kBQ;
  constexpr int MT = C::kMT;
  constexpr int NO = D / 8;
  constexpr int NT = BK / 8;
  constexpr int kStage = (BQ + BK) * P;  // elements of a ring stage

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int4 item = items[blockIdx.x / bh_count];
  const int bh = blockIdx.x % bh_count;
  const int slab = blockIdx.y;
  const int q0 = item.x * BQ;
  const int kt0 = item.y;
  const int n_chunks = depth / D;
  const int steps = (item.z - item.y) * (n_chunks + 1);
  const int warp = threadIdx.x / 32;
  const int qw = q0 + warp * 16 * MT;  // this warp's first row
  const int diag = sk - sq;            // bottom-right causal alignment
  const int active = min(MT, max(0, (sq - qw + 15) / 16));

  const T* qb = q + (int64_t)bh * sq * depth;
  const T* kb = k + (int64_t)bh * sk * depth;
  const T* vb = v + (int64_t)bh * sk * depth + slab * D;

  // the next step to load: its chunk (n_chunks = the V slab) and key row;
  // counters, not a division by n_chunks + 1, keep the loop in registers
  int ld_c = 0, ld_k0 = kt0 * BK;
  auto load_next = [&](int stage) {
    T* st = ring + stage * kStage;
    if (ld_c < n_chunks) {
      load_rows<T, D, P, X::kThreads>(st, qb + ld_c * D, q0, BQ, sq, depth);
      load_rows<T, D, P, X::kThreads>(st + BQ * P, kb + ld_c * D, ld_k0, BK,
                                      sk, depth);
      ++ld_c;
    } else {
      load_rows<T, D, P, X::kThreads>(st, vb, ld_k0, BK, sk, depth);
      ld_c = 0;
      ld_k0 += BK;
    }
  };

#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < steps) load_next(i);
    cp_async_commit();
  }

  float acc[MT][NO][4];
  float mrow[MT][2], lrow[MT][2];
  STile<T, D> s;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
    mrow[mt][0] = mrow[mt][1] = -CUDART_INF_F;
    lrow[mt][0] = lrow[mt][1] = 0.f;
  }

  int c = 0, k0 = kt0 * BK;  // this step's chunk and key row
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();  // step j landed; every warp is done with step j - 1
    if (j + C::kStages - 1 < steps)
      load_next((j + C::kStages - 1) % C::kStages);
    cp_async_commit();
    const T* st = ring + (j % C::kStages) * kStage;
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
          s[mt][jj][0] = s[mt][jj][1] = s[mt][jj][2] = s[mt][jj][3] = 0.f;
    }
    if (c < n_chunks) {
      const T* q_w = st + warp * 16 * MT * P;
      if (active == MT)
        qk_product<T, D, MT>(q_w, st + BQ * P, s);
      else if (MT > 1 && active > 0)  // rows past Sq: nothing to compute
        qk_product<T, D, 1>(q_w, st + BQ * P, s);
      ++c;
    } else {
      if (active == MT)
        softmax_pv<T, D, MT>(s, st, k0, qw, sk, diag, causal, scale_log2,
                             acc, mrow, lrow);
      else if (MT > 1 && active > 0)
        softmax_pv<T, D, 1>(s, st, k0, qw, sk, diag, causal, scale_log2, acc,
                            mrow, lrow);
      c = 0;
      k0 += BK;
    }
  }

  write_result<T, D>(acc, mrow, lrow, o, part, item.w, bh, q0, sq, depth,
                     slab * D, slab == 0, n_slots);
}

// Merge the key-split partials of every output element, slots in order:
// ranges[qt] = (first slot, count).  Deterministic; a row no split saw
// (m = -inf everywhere) comes out exactly 0.
template <typename T>
__global__ void __launch_bounds__(256)
flash_combine_kernel(const float* __restrict__ part,
                     const int2* __restrict__ ranges, T* __restrict__ o,
                     int sq, int d, int bq, int n_slots, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= total) return;
  const int col = (int)(idx % d);
  const int64_t row_g = idx / d;
  const int row = (int)(row_g % sq);
  const int64_t bh = row_g / sq;
  const int2 rg = ranges[row / bq];
  const int r = row % bq;
  const int64_t stride = (int64_t)bq * (d + 2);
  const float* pb = part + (bh * n_slots + rg.x) * stride;
  float m = -CUDART_INF_F;
  for (int s = 0; s < rg.y; ++s) m = fmaxf(m, pb[s * stride + bq * d + r]);
  const float base = m == -CUDART_INF_F ? 0.f : m;
  float l = 0.f, a = 0.f;
  for (int s = 0; s < rg.y; ++s) {
    const float* ps = pb + s * stride;
    const float w = exp2f(ps[bq * d + r] - base);
    l += w * ps[bq * d + bq + r];
    a += w * ps[r * d + col];
  }
  const float out = a / fmaxf(l, 1e-30f);
  if constexpr (sizeof(T) == 4)
    o[idx] = out;
  else
    o[idx] = __float2bfloat16(out);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           float* part, const int4* items, int n_items, int bh, int sq,
           int sk, int causal, float scale_log2, int n_slots,
           cudaStream_t stream) {
  using X = Tiles<T, D>;
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)X::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const long long blocks = (long long)n_items * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<T, D><<<(unsigned)blocks, X::kThreads, X::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), part, items, bh, sq, sk,
      causal, scale_log2, n_slots);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_slabs(const void* q, const void* k, const void* v, void* o,
                 float* part, const int4* items, int n_items, int bh, int sq,
                 int sk, int causal, float scale_log2, int n_slots, int depth,
                 cudaStream_t stream) {
  using X = Tiles<T, kSlab>;
  constexpr size_t kSmem =
      sizeof(T) * Cfg<T, kSlab>::kStages * (X::kBQ + Cfg<T, kSlab>::kBK) *
      Cfg<T, kSlab>::kPitch;
  static_assert(kSmem == X::kSmem, "the slab kernel's ring is the D = 128 "
                "kernel's shared memory");
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_slab_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const long long blocks = (long long)n_items * bh;
  const int slabs = depth / kSlab;
  if (blocks > 0x7fffffffLL || slabs > 65535)
    return (int)cudaErrorInvalidValue;
  flash_fwd_slab_kernel<T>
      <<<dim3((unsigned)blocks, (unsigned)slabs), X::kThreads, kSmem,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<T*>(o), part, items,
                   bh, sq, sk, causal, scale_log2, n_slots, depth);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               float* part, const int4* items, int n_items, int bh, int sq,
               int sk, int causal, float scale_log2, int n_slots,
               cudaStream_t st) {
#define MXT_FLASH_CASE(DD)                                                 \
  case DD:                                                                 \
    return launch<T, DD>(q, k, v, o, part, items, n_items, bh, sq, sk,     \
                         causal, scale_log2, n_slots, st);
  if (d > kSlab && d % kSlab == 0)
    return launch_slabs<T>(q, k, v, o, part, items, n_items, bh, sq, sk,
                           causal, scale_log2, n_slots, d, st);
  switch (d) {
    MXT_FLASH_CASE(8)
    MXT_FLASH_CASE(16)
    MXT_FLASH_CASE(32)
    MXT_FLASH_CASE(64)
    MXT_FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MXT_FLASH_CASE
}

template <typename T>
int combine(const float* part, const int2* ranges, void* o, int bh, int sq,
            int d, int bq, int n_slots, cudaStream_t st) {
  const int64_t total = (int64_t)bh * sq * d;
  const int64_t blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_combine_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      part, ranges, static_cast<T*>(o), sq, d, bq, n_slots, total);
  return (int)cudaGetLastError();
}

template <typename T>
int block_sizes(int d, int* bq, int* bk) {
  switch (d) {
    case 8: *bq = Tiles<T, 8>::kBQ; *bk = Cfg<T, 8>::kBK; return 0;
    case 16: *bq = Tiles<T, 16>::kBQ; *bk = Cfg<T, 16>::kBK; return 0;
    case 32: *bq = Tiles<T, 32>::kBQ; *bk = Cfg<T, 32>::kBK; return 0;
    case 64: *bq = Tiles<T, 64>::kBQ; *bk = Cfg<T, 64>::kBK; return 0;
    case 128: *bq = Tiles<T, 128>::kBQ; *bk = Cfg<T, 128>::kBK; return 0;
    default:
      if (d <= kSlab || d % kSlab != 0) return (int)cudaErrorInvalidValue;
      // a depth of several slabs runs the D = 128 tiles
      *bq = Tiles<T, kSlab>::kBQ;
      *bk = Cfg<T, kSlab>::kBK;
      return 0;
  }
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = fp32, 1 = bf16.

// The query rows and keys per tile of the (dtype, head_dim) kernel, which
// the wrapper's work plan is made of: head_dim 8, 16, 32, 64, 128 or a
// multiple of 128 (the slab kernel, whose tiles are the D = 128 ones).
// Returns 0, or cudaErrorInvalidValue.
extern "C" int mxt_flash_block_sizes(int dtype, int head_dim, int* block_q,
                                     int* block_k) {
  if (dtype == 0) return block_sizes<float>(head_dim, block_q, block_k);
  if (dtype == 1)
    return block_sizes<__nv_bfloat16>(head_dim, block_q, block_k);
  return (int)cudaErrorInvalidValue;
}

// plan (int32, on the card): n_items rows of (q tile, kt0, kt1, slot),
// heaviest first, then n_qtiles rows of (first slot, count).  scratch ==
// NULL: every q tile is one item and writes the output.  Otherwise every
// item writes a partial to scratch (bh * n_items * block_q * (head_dim + 2)
// floats) and a second kernel merges them.  Returns the cudaError_t of the
// launches (0 = launched).
extern "C" int mxt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int bh,
                                       int sq, int sk, int head_dim,
                                       int dtype, int causal, float sm_scale,
                                       const void* plan, int n_items,
                                       void* scratch, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || n_items <= 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
        (uintptr_t)plan) % 16) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* items = static_cast<const int4*>(plan);
  float* part = static_cast<float*>(scratch);
  const float scale_log2 = sm_scale * kLog2e;
  int bq = 0, bk = 0;
  int rc = mxt_flash_block_sizes(dtype, head_dim, &bq, &bk);
  if (rc != 0) return rc;
  if (dtype == 0)
    rc = dispatch_d<float>(head_dim, q, k, v, o, part, items, n_items, bh,
                           sq, sk, causal, scale_log2, n_items, st);
  else
    rc = dispatch_d<__nv_bfloat16>(head_dim, q, k, v, o, part, items,
                                   n_items, bh, sq, sk, causal, scale_log2,
                                   n_items, st);
  if (rc != 0 || part == nullptr) return rc;
  const int2* ranges = reinterpret_cast<const int2*>(items + n_items);
  if (dtype == 0)
    return combine<float>(part, ranges, o, bh, sq, head_dim, bq, n_items,
                          st);
  return combine<__nv_bfloat16>(part, ranges, o, bh, sq, head_dim, bq,
                                n_items, st);
}
