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
// s_part [2, groups, Ci] and dw_part [splits, Ci, Co], fp32.  Any M, Ci and
// Co: rows past M, and columns past Ci or Co, are zero in every product and
// every sum.
//
// Two passes and fixed-order reduces.  The TPU kernel walks a sequential
// grid and carries dW/s1/s2 in VMEM scratch from step to step; on the card
// blocks run in parallel, so the work splits in two passes and partial sums
// are reduced in a fixed order afterwards -- no float atomics, so two runs
// give the same bits:
//   1. d_act pass, grid (Ci tiles, row groups).  A CTA walks its group's
//      row blocks, forms each block's tile of d_act (K = Co), and in the
//      epilogue reads u, recomputes act, masks, writes d_bn and adds to its
//      per-column s1/s2 partials; one partial per group.
//   2. dW pass, grid (Ci tiles x Co tiles, M splits).  Split-K over M: a
//      CTA forms its tile of relu_act^T . dy over its rows, recomputing
//      relu_act from u; one partial per split.
//   3. reduce_dw_kernel / reduce_s_kernel: sum the partials in order.
// Two passes read dy twice.  At ResNet-50's stage 1 (M = 401,408, Co = 256)
// the second read is 205.5 MB, 0.061 ms at 3.35 TB/s, and at stages 3-4 dy
// (51 and 26 MB) largely stays in the 50 MB L2; the products, not the
// bytes, were what the first kernel lost its time to, so the passes stay.
//
// bf16 (the training step's path): both products run on the tensor cores,
// mma.sync m16n8k16 with bf16 operands from ldmatrix and fp32 accumulators.
// Products of bf16 values are exact in fp32, so only the order of the sums
// differs from the plain version.  Tiles of 32-deep K slices stream through
// a 3-stage ring in shared memory filled by 16-byte cp.async copies, so the
// next slices load while this one is multiplied; rows are padded by 16
// bytes so that ldmatrix reads hit 32 distinct banks.  4 warps a CTA.
//   - d_act (dact_mma_kernel): CTA tile 128 rows x 64 Ci, each warp 32 rows
//     x 64; A = dy [row][k] by ldmatrix, B = wt [k][ci] by ldmatrix.trans.
//     The epilogue works on the accumulator fragments; the s1/s2 column
//     partials go across the fragment's row lanes by a fixed shuffle tree,
//     then across the warps in shared memory in warp order.
//   - dW (dw_mma_kernel): CTA tile 64 Ci x 128 Co, warps 2 x 2 of 32 x 64.
//     Each landed u slice is turned into relu_act in place (bn_act, relu,
//     bf16 cast, rows past the split zeroed), and read as A = relu_act^T by
//     ldmatrix.trans; B = the dy slice [m][co] by ldmatrix.trans.
//   Where a row is not 16-byte aligned (Ci or Co not a multiple of 8, or an
//   operand at an odd offset) the same kernels, instantiated with
//   kVec = false, fill the ring with element loads instead; past the edges
//   both write zeros.
// fp32 keeps the first kernels (dact_kernel, dw_kernel): fp32 FMAs on the
// CUDA cores from 16-deep shared-memory tiles, 4 x 4 outputs a thread.  It
// runs only in the fp32 card-against-host step and the checks; split TF32
// on the tensor cores for it is later work.
//
// What bounds it on an H100: the function reads dy and u once, writes d_bn
// (bytes) and does 4 * M * Ci * Co FLOPs (26.3 GFLOP at every ResNet-50
// stage at batch 128).  In bf16 the bytes bound stages 1-2 (0.092 and 0.046
// ms) and the tensor cores' 989 TFLOP/s stages 3-4 (0.027 ms); fp32 is
// bound by the CUDA cores' 67 TFLOP/s (0.39 ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // fp32: output tile rows and columns
constexpr int kDepth = 16;     // fp32: K slice staged in shared memory
constexpr int kThreads = 256;  // fp32: 16 x 16 threads, 4 x 4 outputs each

// bf16 tensor-core tiles
constexpr int kBK = 32;           // K slice (Co for d_act, rows for dW)
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kDaBM = 128;        // d_act: rows a CTA tile
constexpr int kDaBN = 64;         // d_act: Ci a CTA tile
constexpr int kDaPitchA = kBK + 8;    // dy slice [row][k]
constexpr int kDaPitchB = kDaBN + 8;  // wt slice [k][ci]
constexpr int kDwBM = 64;         // dW: Ci a CTA tile
constexpr int kDwBN = 128;        // dW: Co a CTA tile
constexpr int kDwPitchA = kDwBM + 8;  // u / relu_act slice [row][ci]
constexpr int kDwPitchB = kDwBN + 8;  // dy slice [row][co]
constexpr int kSplitAlign = 32;   // a dW split's rows: a multiple of this

// Rows per split of the dW pass; split s covers [s * rows, (s + 1) * rows)
// clipped to M.  The wrapper's plan (ops/pallas_conv.py) mirrors this.
__device__ __forceinline__ int split_rows(int m, int splits) {
  return ((m + splits - 1) / splits + kSplitAlign - 1) / kSplitAlign *
         kSplitAlign;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// act = cast_T(u * g + b) as a float, with the multiply and the add rounded
// separately (no FMA contraction), as the plain version computes it.
template <typename T>
__device__ __forceinline__ float bn_act(float u32, float g, float b) {
  return to_f(from_f<T>(__fadd_rn(__fmul_rn(u32, g), b)));
}

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

// ------------------------------------------------- fp32 on the CUDA cores
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
  const int rows = split_rows(m, splits);
  const int r_begin = min(m, split * rows);
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

// ------------------------------------------------- bf16 on the tensor cores
// Rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major bf16 matrix of
// leading dimension ld into shared memory of pitch P; elements at or past
// row_end or col_end are zero.  kVec: 16-byte cp.async copies (ld a
// multiple of 8 and the base 16-byte aligned, so a chunk of 8 lies wholly
// inside or wholly past col_end); else element loads.
template <int R, int C, int P, bool kVec>
__device__ __forceinline__ void load_slice(bf16* dst, const bf16* src,
                                           int64_t ld, int r0, int row_end,
                                           int c0, int col_end) {
  constexpr int kChunks = C / 8;  // per row
  static_assert(R * kChunks % kMmaThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < R * kChunks / kMmaThreads; ++i) {
    const int idx = threadIdx.x + i * kMmaThreads;
    const int r = idx / kChunks;
    const int c = idx % kChunks * 8;
    const int row = r0 + r, col = c0 + c;
    bf16* d = dst + r * P + c;
    if constexpr (kVec) {
      const bool ok = row < row_end && col < col_end;
      cp_async16(d, ok ? src + (int64_t)row * ld + col : src, ok ? 16 : 0);
    } else {
      const bool live = row < row_end;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = live && col + e < col_end ? src[(int64_t)row * ld + col + e]
                                         : __ushort_as_bfloat16(0);
    }
  }
}

// d_act pass.  grid (ceil(Ci / 64), groups); group grp walks row blocks
// [grp * per, min(n_blocks, (grp + 1) * per)) of 128 rows, per =
// ceil(n_blocks / groups).
template <bool kVec>
__global__ void __launch_bounds__(kMmaThreads)
dact_mma_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ u,
                const bf16* __restrict__ wt, const float* __restrict__ g,
                const float* __restrict__ b, const float* __restrict__ mu,
                const float* __restrict__ inv, bf16* __restrict__ d_bn,
                float* __restrict__ s_part, int m, int ci, int co,
                int groups) {
  __shared__ __align__(16) uint16_t a_raw[kStages][kDaBM * kDaPitchA];
  __shared__ __align__(16) uint16_t b_raw[kStages][kBK * kDaPitchB];
  __shared__ float par[4][kDaBN];     // g, b, mu, inv of the tile's columns
  __shared__ float red[2][4][kDaBN];  // s1, s2 column sums of each warp

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, thread
  const int ci0 = blockIdx.x * kDaBN;
  const int grp = blockIdx.y;
  const int n_blocks = (m + kDaBM - 1) / kDaBM;
  const int per = (n_blocks + groups - 1) / groups;
  const int rb_begin = grp * per;
  const int rb_end = min(n_blocks, rb_begin + per);
  const int n_k = (co + kBK - 1) / kBK;

  for (int i = tid; i < 4 * kDaBN; i += kMmaThreads) {
    const int which = i / kDaBN, c = i % kDaBN;
    const float* src = which == 0 ? g : which == 1 ? b : which == 2 ? mu
                                                                  : inv;
    par[which][c] = ci0 + c < ci ? src[ci0 + c] : 0.f;
  }
  __syncthreads();

  float s1[8][2], s2[8][2];  // columns nt * 8 + 2 tq + e
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;

  for (int rb = rb_begin; rb < rb_end; ++rb) {
    const int m0 = rb * kDaBM;
    auto load = [&](int kt) {
      const int st = kt % kStages, k0 = kt * kBK;
      load_slice<kDaBM, kBK, kDaPitchA, kVec>(
          reinterpret_cast<bf16*>(a_raw[st]), dy, co, m0, m, k0, co);
      load_slice<kBK, kDaBN, kDaPitchB, kVec>(
          reinterpret_cast<bf16*>(b_raw[st]), wt, ci, k0, co, ci0, ci);
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_k) load(s);
      cp_async_commit();
    }
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] =
            0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // slice kt landed; every warp is done with kt - 1
      if (kt + kStages - 1 < n_k) load(kt + kStages - 1);
      cp_async_commit();
      const bf16* as = reinterpret_cast<const bf16*>(a_raw[kt % kStages]) +
                       warp * 32 * kDaPitchA;
      const bf16* bs = reinterpret_cast<const bf16*>(b_raw[kt % kStages]);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(af[mt], as + (mt * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * kDaPitchA +
                                  kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, bs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                       (lane & 7)) * kDaPitchB +
                                     np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next row block

    // epilogue on the fragments: c[2 h + e] is row gq + 8 h, column 2 tq + e
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp * 32 + mt * 16 + gq + 8 * h;
        if (row >= m) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = nt * 8 + 2 * tq;
          const int col = ci0 + c;
          if (col >= ci) continue;
          const int64_t at = (int64_t)row * ci + col;
          const bool two = kVec || col + 1 < ci;
          float uv[2];
          if (kVec) {
            const __nv_bfloat162 p =
                *reinterpret_cast<const __nv_bfloat162*>(u + at);
            uv[0] = __low2float(p);
            uv[1] = __high2float(p);
          } else {
            uv[0] = __bfloat162float(u[at]);
            uv[1] = two ? __bfloat162float(u[at + 1]) : 0.f;
          }
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool mask =
                bn_act<bf16>(uv[e], par[0][c + e], par[1][c + e]) > 0.f;
            d[e] = mask && (e == 0 || two) ? acc[mt][nt][2 * h + e] : 0.f;
            const float xhat =
                __fmul_rn(__fsub_rn(uv[e], par[2][c + e]), par[3][c + e]);
            s1[nt][e] += d[e];
            s2[nt][e] = fmaf(d[e], xhat, s2[nt][e]);
          }
          if (kVec) {
            *reinterpret_cast<__nv_bfloat162*>(d_bn + at) =
                __floats2bfloat162_rn(d[0], d[1]);
          } else {
            d_bn[at] = __float2bfloat16_rn(d[0]);
            if (two) d_bn[at + 1] = __float2bfloat16_rn(d[1]);
          }
        }
      }
    }
  }

  // column sums: over the 8 row groups of the warp by a fixed shuffle
  // tree, then over the 4 warps in order
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        s1[nt][e] += __shfl_xor_sync(0xffffffffu, s1[nt][e], off);
        s2[nt][e] += __shfl_xor_sync(0xffffffffu, s2[nt][e], off);
      }
  if (gq == 0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[0][warp][nt * 8 + 2 * tq + e] = s1[nt][e];
        red[1][warp][nt * 8 + 2 * tq + e] = s2[nt][e];
      }
  }
  __syncthreads();
  {
    const int which = tid / kDaBN, c = tid % kDaBN;  // 128 = 2 x 64
    const float sum = ((red[which][0][c] + red[which][1][c]) +
                       red[which][2][c]) + red[which][3][c];
    if (ci0 + c < ci)
      s_part[((int64_t)which * groups + grp) * ci + ci0 + c] = sum;
  }
}

// dW pass.  grid (ceil(Ci / 64) * ceil(Co / 128), splits); split s takes
// rows [s * rows, min(M, (s + 1) * rows)), rows = split_rows(M, splits).
template <bool kVec>
__global__ void __launch_bounds__(kMmaThreads)
dw_mma_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ u,
              const float* __restrict__ g, const float* __restrict__ b,
              float* __restrict__ dw_part, int m, int ci, int co,
              int splits) {
  __shared__ __align__(16) uint16_t a_raw[kStages][kBK * kDwPitchA];
  __shared__ __align__(16) uint16_t b_raw[kStages][kBK * kDwPitchB];
  __shared__ float par[2][kDwBM];  // g, b of the tile's Ci columns

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int wm = warp / 2, wn = warp % 2;  // 32 Ci x 64 Co of the tile
  const int co_tiles = (co + kDwBN - 1) / kDwBN;
  const int ci0 = (blockIdx.x / co_tiles) * kDwBM;
  const int co0 = (blockIdx.x % co_tiles) * kDwBN;
  const int split = blockIdx.y;
  const int rows = split_rows(m, splits);
  const int r_begin = min(m, split * rows);
  const int r_end = min(m, r_begin + rows);
  const int n_k = (r_end - r_begin + kBK - 1) / kBK;

  for (int i = tid; i < 2 * kDwBM; i += kMmaThreads) {
    const int which = i / kDwBM, c = i % kDwBM;
    par[which][c] = ci0 + c < ci ? (which == 0 ? g : b)[ci0 + c] : 0.f;
  }
  // (the first wait/sync of the loop orders par before its first use)

  auto load = [&](int kt) {
    const int st = kt % kStages, r0 = r_begin + kt * kBK;
    load_slice<kBK, kDwBM, kDwPitchA, kVec>(
        reinterpret_cast<bf16*>(a_raw[st]), u, ci, r0, r_end, ci0, ci);
    load_slice<kBK, kDwBN, kDwPitchB, kVec>(
        reinterpret_cast<bf16*>(b_raw[st]), dy, co, r0, r_end, co0, co);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s);
    cp_async_commit();
  }
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] =
          0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed; every warp is done with kt - 1
    if (kt + kStages - 1 < n_k) load(kt + kStages - 1);
    cp_async_commit();
    // relu_act = relu(cast(u * g + b)) in place, in pairs of columns;
    // rows past the split stay zero
    bf16* as = reinterpret_cast<bf16*>(a_raw[kt % kStages]);
    const int r0 = r_begin + kt * kBK;
#pragma unroll
    for (int i = 0; i < kBK * kDwBM / 2 / kMmaThreads; ++i) {
      const int idx = tid + i * kMmaThreads;
      const int r = idx / (kDwBM / 2), c = idx % (kDwBM / 2) * 2;
      __nv_bfloat162* p =
          reinterpret_cast<__nv_bfloat162*>(as + r * kDwPitchA + c);
      const bool live = r0 + r < r_end;
      const __nv_bfloat162 v = *p;
      float a0 = bn_act<bf16>(__low2float(v), par[0][c], par[1][c]);
      float a1 = bn_act<bf16>(__high2float(v), par[0][c + 1], par[1][c + 1]);
      a0 = live && a0 > 0.f ? a0 : 0.f;
      a1 = live && a1 > 0.f ? a1 : 0.f;
      *p = __floats2bfloat162_rn(a0, a1);
    }
    __syncthreads();
    const bf16* bs = reinterpret_cast<const bf16*>(b_raw[kt % kStages]);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];  // A = relu_act^T: the [row][ci] slice transposed
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4_trans(af[mt], as + (kk * 16 + (lane & 7) +
                                        (lane >> 4) * 8) * kDwPitchA +
                                      wm * 32 + mt * 16 +
                                      ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, bs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                     (lane & 7)) * kDwPitchB +
                                   wn * 64 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // every split writes its whole tile (zeros where it had no rows)
  float* out = dw_part + (int64_t)split * ci * co;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ci0 + wm * 32 + mt * 16 + gq + 8 * h;
      if (r >= ci) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = co0 + wn * 64 + nt * 8 + 2 * tq;
        float* o = out + (int64_t)r * co + c;
        if (kVec) {
          if (c < co)
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        } else {
          if (c < co) o[0] = acc[mt][nt][2 * h];
          if (c + 1 < co) o[1] = acc[mt][nt][2 * h + 1];
        }
      }
    }
}

int reduce(float* dw, float* s, const float* s_part, const float* dw_part,
           int ci, int co, int groups, int splits, cudaStream_t st) {
  const int64_t n_dw = (int64_t)ci * co;
  reduce_dw_kernel<<<(unsigned)((n_dw + kThreads - 1) / kThreads), kThreads,
                     0, st>>>(dw_part, dw, n_dw, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = kThreads / 32;
  reduce_s_kernel<<<(2 * ci + warps_per_block - 1) / warps_per_block,
                    kThreads, 0, st>>>(s_part, s, ci, groups);
  return (int)cudaGetLastError();
}

int launch_f32(const float* dy, const float* u, const float* wt,
               const float* g, const float* b, const float* mu,
               const float* inv, float* d_bn, float* dw, float* s,
               float* s_part, float* dw_part, int m, int ci, int co,
               int groups, int splits, cudaStream_t st) {
  const int ci_tiles = (ci + kTile - 1) / kTile;
  const int co_tiles = (co + kTile - 1) / kTile;
  dact_kernel<float><<<dim3(ci_tiles, groups), kThreads, 0, st>>>(
      dy, u, wt, g, b, mu, inv, d_bn, s_part, m, ci, co, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_kernel<float><<<dim3(ci_tiles * co_tiles, splits), kThreads, 0, st>>>(
      dy, u, g, b, dw_part, m, ci, co, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce(dw, s, s_part, dw_part, ci, co, groups, splits, st);
}

template <bool kVec>
int launch_bf16(const bf16* dy, const bf16* u, const bf16* wt,
                const float* g, const float* b, const float* mu,
                const float* inv, bf16* d_bn, float* dw, float* s,
                float* s_part, float* dw_part, int m, int ci, int co,
                int groups, int splits, cudaStream_t st) {
  const int da_tiles = (ci + kDaBN - 1) / kDaBN;
  const int dw_tiles =
      (ci + kDwBM - 1) / kDwBM * ((co + kDwBN - 1) / kDwBN);
  dact_mma_kernel<kVec><<<dim3(da_tiles, groups), kMmaThreads, 0, st>>>(
      dy, u, wt, g, b, mu, inv, d_bn, s_part, m, ci, co, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_mma_kernel<kVec><<<dim3(dw_tiles, splits), kMmaThreads, 0, st>>>(
      dy, u, g, b, dw_part, m, ci, co, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce(dw, s, s_part, dw_part, ci, co, groups, splits, st);
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
    return launch_f32(static_cast<const float*>(dy),
                      static_cast<const float*>(u),
                      static_cast<const float*>(wt), gf, bf, muf, invf,
                      static_cast<float*>(d_bn), dwf, sf, spf, dwpf, m, ci,
                      co, groups, splits, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const bf16* dyh = static_cast<const bf16*>(dy);
  const bf16* uh = static_cast<const bf16*>(u);
  const bf16* wth = static_cast<const bf16*>(wt);
  bf16* d_bnh = static_cast<bf16*>(d_bn);
  // 16-byte rows and bases: cp.async copies; else element loads
  const bool vec = ci % 8 == 0 && co % 8 == 0 &&
                   (((uintptr_t)dy | (uintptr_t)u | (uintptr_t)wt |
                     (uintptr_t)d_bn | (uintptr_t)dw_part) % 16) == 0;
  if (vec)
    return launch_bf16<true>(dyh, uh, wth, gf, bf, muf, invf, d_bnh, dwf, sf,
                             spf, dwpf, m, ci, co, groups, splits, st);
  return launch_bf16<false>(dyh, uh, wth, gf, bf, muf, invf, d_bnh, dwf, sf,
                            spf, dwpf, m, ci, co, groups, splits, st);
}
