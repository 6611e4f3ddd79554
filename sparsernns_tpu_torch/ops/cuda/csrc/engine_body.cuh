// Shared device code of the serving-engine kernels: the parts of one
// quantized serving layer (and the encoder / decoder dense) on a tile of
// kT frames held in shared memory. The serving passes (engine_passes.cuh,
// for engine_layer.cu, engine_network.cu and the mixer alone, fused_s5.cu,
// and the QAT mixer's row passes in qat_scan.cu) compute every product and
// every requantization through the functions below, so every route gives
// bit-identical results: the function, not the route, fixes the order of
// each sum. A float dot over int8 codes that come with their fragments
// (every dense of the w8a16 engine) runs on the tensor cores over exact
// bf16 planes (tile_matmul_mma, bf16_planes.cuh): the fmaf chain's
// products, summed per 16-deep k-step in the tile's order. A float dot
// over f32 or int16 weights (K4a's float mode, a w16 pack), or over int8
// codes without fragments (the QAT mixer's, new every step; an
// integer-dot engine's), is one fmaf chain in ascending k, in the 4-column
// register tiles where the width allows; integer dots (__dp4a) are exact.
//
// The layer body is the TPU kernels' (sparsernns_tpu/ops/pallas/
// fused_layer.py `_mixer_pre`, scan_kernel.py `scan_block_body`,
// fused_layer.py `_mixer_post`), float-dot mode:
//
//   z  = r * nw + nb                        (prenorm affine, else z = r)
//   bu = (z @ W_b) * (s_b_re | s_b_im)      (weights int8/int16/f32 as f32)
//   x_t = lam * x_{t-1} + bu_t              (f32, in order over time)
//   every `block_t` frames: all states of the block are requantized onto
//     the frozen (s_re, s_im, bits) grid and the requantized last state
//     is the carry into the next block; inside a block the recurrence
//     runs on unquantized f32 from that carry
//   y  = [relu?(x_re) * s_c_re | relu?(x_im) * s_c_im] @ W_c + d * z
//   x1 = relu(y) or gelu_tanh(y)
//   h  = GLU(x1, y)  (gate = sigmoid((x1 @ W_2) * s_2 + b_2))
//   h  = h + r; postnorm affine if not prenorm; relu if relufication
//
// Integer-dot modes (fused_layer.py `_glu_dense` :117, `_mixer_pre` :139
// with mixer_in16, `_mixer_post` :185 with state16; fused_network.py
// `_boundary_dense` :125), each switched on per dot site by its fields:
//
//   a dense with a frozen activation grid (DenseW.in_mode): the operand's
//     codes q = clip(rint(a / s)) go into int8 planes (the code itself at 8
//     bits or fewer; hi = q >> 8 and lo - 128 = (q & 255) - 128 up to 16),
//     the products accumulate in int32 by __dp4a, and the planes combine
//     as ops/intdot.py does (one int32 accumulator with 128 * colsum, or
//     plane-wise in f32); value = acc * (s * w_scale) + bias, then the
//     optional output requant (quant_output);
//   mixer_in16 (ut_mode): the B-projection on the codes of z on the
//     quant_ut grid, per-half scales s_ut * s_b, and the D term on
//     code * s_ut; quant_but (but_bits) after the B-projection;
//   state16 (st_mode): the C-projection on the states' codes (they lie on
//     the block-requant grid: code = x * (1/s) exactly), one integer dot
//     per half with its own colsum; quant_yt (yt_bits) after + d * z_d.
//
// Integer dots are exact, so they add no summation-order difference. The
// kernels of other modules that include this header (fused_s5.cu,
// qat_scan.cu) leave every integer field zero and take none of these
// branches.
//
// The layer's result h (before the output requant) replaces r in shared
// memory.
// Rounding is round-half-to-even (rintf) with the clip after it; scales
// divide, as in the reference. No fast-math intrinsics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_planes.cuh"
#include "scan_step.cuh"

namespace engine {

constexpr int kT = 32;        // frames per tile
constexpr int kRT = 8;        // accumulator rows per thread
constexpr int kThreads = 256;

enum Glu { kFull = 0, kHalf1 = 1, kHalf2 = 2, kNone = 3 };
enum WType { kWF32 = 0, kWI8 = 1, kWI16 = 2 };
enum IoType { kIoF32 = 0, kIoBF16 = 1, kIoI16 = 2, kIoI8 = 3 };
// How a dot runs: on the float operand, or on its integer codes in one
// int8 plane, two planes in one int32 accumulator, or two planes combined
// in f32 (ops/intdot.py DOT_I8, DOT_I16, DOT_I16_PLANES).
enum DotMode { kDotFloat = 0, kDotI8 = 1, kDotI16 = 2, kDotI16Planes = 3 };

// A dense weight (K, N) row-major with its per-tensor scale and bias, and
// the integer dot that runs it where its input has a frozen grid.
struct DenseW {
  const void* w;
  const float* bias;   // (N) or null
  const int* colsum;   // (N) column sums of the int8 weight (two planes)
  const uint4* wf;     // int8 w: its codes as mma's bf16 B fragments
                       // (ops/cuda/engine_layer.py `mma_fragments`)
  float scale;         // 1 when the weight is float
  float acc_scale;     // in_s * scale: integer accumulator -> value
  float in_s;          // the input's grid (in_mode != kDotFloat)
  float out_s;         // output requant after the bias (out_bits != 0)
  int wtype;           // WType
  int in_mode;         // DotMode
  int in_bits, out_bits;
};

// One layer's operands. The layout is mirrored by a ctypes.Structure in
// ops/cuda/engine_layer.py: pointers first, then 4-byte fields.
struct LayerParams {
  const float* lam_re;   // (P)
  const float* lam_im;
  const float* d;        // (H)
  const float* nw;       // (H)
  const float* nb;
  const int* cs_wb;      // (2P) column sums of W_b (two-plane B-projection)
  const int* cs_wc_re;   // (H) column sums of W_c's rows [0, P)
  const int* cs_wc_im;   // (H) of its rows [P, 2P)
  DenseW wb;             // (H, 2P) [B_re^T | B_im^T]
  DenseW wc;             // (2P, H) [C_re^T ; -C_im^T]
  DenseW out2;           // (H, H) gate dense, w null without a GLU
  DenseW out1;           // (H, H) value dense of the "full" GLU
  float wb_s_re, wb_s_im;      // per-half weight scales (1 if float)
  float wc_s_re, wc_s_im;      // incl. the conj-sym factor 2
  float sq_re, sq_im, sq_min, sq_max;   // block state requant grid
  float rq_s, rq_min, rq_max;           // output (residual) requant grid
  float ut_s, ut_sc_re, ut_sc_im;       // quant_ut grid; ut_s * wb_s_*
  float st_inv_re, st_inv_im;           // 1 / sq_*: state -> code
  float st_sc_re, st_sc_im;             // sq_* * wc_s_*
  float but_re, but_im, yt_s;           // quant_but, quant_yt grids
  int has_sq, has_rq;
  int p;
  int ut_mode, ut_bits;  // DotMode of the B-projection (mixer_in16)
  int st_mode;           // DotMode of the C-projection (state16)
  int but_bits, yt_bits; // 0: requant absent
};

struct Mode {
  int h, prenorm, relufication, glu, relu_state, act_bf16;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// f(r, c) over a rows x width tile: a warp takes a row at a time, its
// lanes neighbouring columns, so no index divides and a warp's accesses of
// a row are contiguous.
template <class F>
__device__ __forceinline__ void for_tile(int rows, int width, F f) {
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5)
#pragma unroll 2
    for (int c = threadIdx.x & 31; c < width; c += 32) f(r, c);
}

// Bytes a row of the code tile Q needs for a layer's integer dots: the
// widest operand they quantize (the im half of the states sits at
// round4(P)).
__host__ inline int code_width(const LayerParams& lp, int h) {
  int w = 0;
  if (lp.ut_mode || lp.out2.in_mode || lp.out1.in_mode) w = h;
  if (lp.st_mode) w = imax(w, 2 * round4(lp.p));
  return w;
}

__device__ inline float ldw(const float* w, long long i) {
  return __ldg(w + i);
}
__device__ inline float ldw(const int8_t* w, long long i) {
  return (float)__ldg(w + i);
}
__device__ inline float ldw(const int16_t* w, long long i) {
  return (float)__ldg(w + i);
}

// out(r, c) = sum_k A[r*lda + k] * W[k*N + c] for the first `rows` rows of
// the tile, k ascending; `epi(r, c, acc)` consumes each result. A lives in
// shared memory with lda % 4 == 0; W (K, N) row-major in device memory,
// streamed from L2 (coalesced along c).
template <class WT, class Epi>
__device__ inline void tile_matmul_t(const float* A, int lda,
                                     const WT* __restrict__ W, int K, int N,
                                     int rows, Epi epi) {
  const int n_items = N * (kT / kRT);
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int c = item % N;
    const int r0 = (item / N) * kRT;
    if (r0 >= rows) continue;
    const float* a = A + r0 * lda;
    float acc[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) acc[r] = 0.f;
    int k = 0;
#pragma unroll 2
    for (; k + 4 <= K; k += 4) {
      const float w0 = ldw(W, (long long)(k + 0) * N + c);
      const float w1 = ldw(W, (long long)(k + 1) * N + c);
      const float w2 = ldw(W, (long long)(k + 2) * N + c);
      const float w3 = ldw(W, (long long)(k + 3) * N + c);
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(a + r * lda + k);
        acc[r] = fmaf(av.x, w0, acc[r]);
        acc[r] = fmaf(av.y, w1, acc[r]);
        acc[r] = fmaf(av.z, w2, acc[r]);
        acc[r] = fmaf(av.w, w3, acc[r]);
      }
    }
    for (; k < K; ++k) {
      const float w = ldw(W, (long long)k * N + c);
#pragma unroll
      for (int r = 0; r < kRT; ++r) acc[r] = fmaf(a[r * lda + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      if (r0 + r < rows) epi(r0 + r, c, acc[r]);
  }
}

// W[i .. i + 3] (four neighbouring columns of one row) as floats. int8
// goes through the exponent trick (0x4B000000 | (b + 128)) - (2^23 + 128),
// exact, on the integer and FMA pipes instead of the slower conversion.
__device__ inline void ldw4(const float* w, long long i, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(w + i));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ inline void ldw4(const int8_t* w, long long i, float* v) {
  const unsigned q =
      __ldg(reinterpret_cast<const unsigned*>(w + i)) ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = __fsub_rn(__uint_as_float(__byte_perm(q, 0x4B000000u, 0x7440 + j)),
                     8388736.f);
}
__device__ inline void ldw4(const int16_t* w, long long i, float* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(w + i));
  v[0] = (float)(int16_t)(q.x & 0xffffu);
  v[1] = (float)(int16_t)(q.x >> 16);
  v[2] = (float)(int16_t)(q.y & 0xffffu);
  v[3] = (float)(int16_t)(q.y >> 16);
}

// tile_matmul_t with a register tile of kRT rows x 4 neighbouring columns
// a thread (N % 4 == 0, W aligned for a 4-column load): every output the
// same fmaf chain in ascending k, each weight load shared by kRT rows and
// each row's operand load by 4 columns.
template <class WT, class Epi>
__device__ inline void tile_matmul4_t(const float* A, int lda,
                                      const WT* __restrict__ W, int K, int N,
                                      int rows, Epi epi) {
  const int n_cg = N / 4;
  const int n_items = n_cg * (kT / kRT);
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int c0 = (item % n_cg) * 4;
    const int r0 = (item / n_cg) * kRT;
    if (r0 >= rows) continue;
    const float* a = A + r0 * lda;
    float acc[kRT][4];
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      float w[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldw4(W, (long long)(k + kk) * N + c0, w[kk]);
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(a + r * lda + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[r][j] = fmaf(av.x, w[0][j], acc[r][j]);
          acc[r][j] = fmaf(av.y, w[1][j], acc[r][j]);
          acc[r][j] = fmaf(av.z, w[2][j], acc[r][j]);
          acc[r][j] = fmaf(av.w, w[3][j], acc[r][j]);
        }
      }
    }
    for (; k < K; ++k) {
      float w[4];
      ldw4(W, (long long)k * N + c0, w);
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[r][j] = fmaf(a[r * lda + k], w[j], acc[r][j]);
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      if (r0 + r < rows)
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(r0 + r, c0 + j, acc[r][j]);
  }
}

// Whether the 4-column tiles take W (K, N) of `bytes` a weight: whole
// groups of 4 columns, each group's load aligned.
__device__ inline bool wide_ok(const void* w, int N, int bytes) {
  return N % 4 == 0 &&
         ((unsigned long long)w & (unsigned long long)(4 * bytes - 1)) == 0;
}

// ---- int8 weights on the tensor cores ----
//
// A @ W for an int8 W (K, N) as mma.sync m16n8k16 over exact bf16 planes
// (bf16_planes.cuh): each float32 value of A (in shared memory) as its
// three split3 planes, each weight code as itself. Every plane product is
// exact in float32. Per 16-deep k-step the planes go lo, mid, hi into
// fresh accumulators (each mma then adds products of one magnitude to a
// smaller partial sum), and the step's sums join the running sums by one
// float32 add each: the tensor cores round their sums toward zero, and an
// accumulator that has grown over many steps would lose the low bits of
// every later product. So the products are the fmaf chain's, summed in
// another order (closer to the exact dot than the chain, on the card).
//
// The 8 warps of a CTA: 2 m-blocks of 16 rows x 4 column lanes. A warp
// takes groups of 32 columns (kMmaGroups at a time, every 4th group) and
// for each k-step splits its A fragment once for all of them. The k order
// inside a step is permuted alike in A and B (mma's k slots 2t, 2t + 1,
// 2t + 8, 2t + 9 of lane t hold k = 4t .. 4t + 3), and n-block j of a group
// takes columns 4n + j (n = mma's n index), so lane (g, t) reads A rows g
// and g + 8 as one float4 each, and its B fragments of a group and step as
// two 16-byte loads of `wf`, which the wrapper lays out once per weight
// (engine_layer.py `mma_fragments`: K padded with zero codes to 16, N to
// 32). Its results land as rows g, g + 8 x columns 8t .. 8t + 7 of each
// group. A past K and rows past `rows` read zeros; columns past N are not
// stored.
constexpr int kMmaGroups = 2;
constexpr int kMmaWarpsN = kThreads / 32 / (kT / 16);
static_assert(kT % 16 == 0 && kMmaWarpsN * (kT / 16) * 32 == kThreads,
              "the warps of a CTA: kT / 16 m-blocks x kMmaWarpsN");

// Lane `lane`'s B fragments of column group `grp`, k-step `ks` (of ks_n):
// words 2j and 2j + 1 are n-block j's b0 and b1; zeros for a group past N.
__device__ __forceinline__ void mma_b_frags(const uint4* __restrict__ wf,
                                            int grp, int n_groups, int ks,
                                            int ks_n, int lane,
                                            uint4 (&f)[2]) {
  if (grp < n_groups && ks < ks_n) {
    const uint4* p = wf + ((long long)(grp * ks_n + ks) * 32 + lane) * 2;
    f[0] = __ldg(p);
    f[1] = __ldg(p + 1);
  } else {
    f[0] = f[1] = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ uint32_t uint4_word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <class Epi>
__device__ inline void tile_matmul_mma(const float* A, int lda,
                                       const uint4* __restrict__ wf, int K,
                                       int N, int rows, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp % (kT / 16)) * 16;
  const int wn = warp / (kT / 16);
  if (m0 >= rows) return;
  const int n_groups = (N + 31) / 32, ks_n = (K + 15) / 16;
  const bool ok0 = m0 + g < rows, ok1 = m0 + g + 8 < rows;
  const float* a_r0 = A + (m0 + g) * lda;
  const float* a_r1 = a_r0 + 8 * lda;
  for (int gb = wn; gb < n_groups; gb += kMmaWarpsN * kMmaGroups) {
    float acc[kMmaGroups][4][4];
#pragma unroll
    for (int i = 0; i < kMmaGroups; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    // the next k-step's fragments load while this one multiplies
    uint4 fc[kMmaGroups][2];
#pragma unroll
    for (int i = 0; i < kMmaGroups; ++i)
      mma_b_frags(wf, gb + i * kMmaWarpsN, n_groups, 0, ks_n, lane, fc[i]);
    for (int ks = 0; ks < ks_n; ++ks) {
      uint4 fn[kMmaGroups][2];
#pragma unroll
      for (int i = 0; i < kMmaGroups; ++i)
        mma_b_frags(wf, gb + i * kMmaWarpsN, n_groups, ks + 1, ks_n, lane,
                    fn[i]);
      // A: rows g, g + 8 at k = kt .. kt + 3, as three planes
      const int kt = 16 * ks + 4 * t;
      float v[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if (kt < K) {
        if (ok0) {
          const float4 q = *reinterpret_cast<const float4*>(a_r0 + kt);
          v[0][0] = q.x, v[0][1] = q.y, v[0][2] = q.z, v[0][3] = q.w;
        }
        if (ok1) {
          const float4 q = *reinterpret_cast<const float4*>(a_r1 + kt);
          v[1][0] = q.x, v[1][1] = q.y, v[1][2] = q.z, v[1][3] = q.w;
        }
#pragma unroll
        for (int e = 1; e < 4; ++e)
          if (kt + e >= K) v[0][e] = v[1][e] = 0.f;
      }
      uint32_t a[3][4];   // a[plane][mma register]
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          uint32_t lo[3], hi[3];
          bf16_planes::split3(v[h][e], lo);
          bf16_planes::split3(v[h][e + 1], hi);
#pragma unroll
          for (int p = 0; p < 3; ++p) a[p][h + e] = lo[p] | (hi[p] << 16);
        }
#pragma unroll
      for (int i = 0; i < kMmaGroups; ++i) {
        if (gb + i * kMmaWarpsN < n_groups) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b0 = uint4_word(fc[i][j >> 1], 2 * (j & 1));
            const uint32_t b1 = uint4_word(fc[i][j >> 1], 2 * (j & 1) + 1);
            float step[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int p = 2; p >= 0; --p)
              bf16_planes::mma_bf16(step, a[p], b0, b1);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] = __fadd_rn(acc[i][j][e], step[e]);
          }
        }
        fc[i][0] = fn[i][0];
        fc[i][1] = fn[i][1];
      }
    }
    // acc[i][j][2h + e]: row g + 8h, column 32 * group + 8t + 4e + j
#pragma unroll
    for (int i = 0; i < kMmaGroups; ++i) {
      const int c0 = (gb + i * kMmaWarpsN) * 32 + 8 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
        if (r >= rows) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + 4 * e + j < N)
              epi(r, c0 + 4 * e + j, acc[i][j][2 * h + e]);
      }
    }
  }
}

// Whether a float dot over the dense runs on the tensor cores: int8 codes
// whose fragments the engine laid out once (engine_layer.py
// `attach_fragments`: every int8 float-dot dense of a network without
// integer dots, the w8a16 engine's; an integer-dot network keeps its float
// dots as fmaf chains, whose codes at the 8-bit activation grids after
// them would move with the order of the sums). Else fmaf tiles, as
// tile_matmul decides.
__host__ __device__ inline bool dot_on_tensor_cores(const DenseW& w) {
  return w.wtype == kWI8 && w.wf != nullptr;
}

// A @ W through the dense: on the tensor cores (dot_on_tensor_cores), else
// as fmaf chains by its weight type, the 4-column register tiles where the
// width allows, else one column a thread.
template <class Epi>
__device__ inline void tile_matmul(const float* A, int lda, const DenseW& w,
                                   int K, int N, int rows, Epi epi) {
  if (dot_on_tensor_cores(w)) {
    tile_matmul_mma(A, lda, w.wf, K, N, rows, epi);
    return;
  }
  if (w.wtype == kWI8 && wide_ok(w.w, N, 1)) {
    tile_matmul4_t(A, lda, static_cast<const int8_t*>(w.w), K, N, rows, epi);
    return;
  }
  if (w.wtype == kWI16 && wide_ok(w.w, N, 2)) {
    tile_matmul4_t(A, lda, static_cast<const int16_t*>(w.w), K, N, rows,
                   epi);
    return;
  }
  if (w.wtype == kWF32 && wide_ok(w.w, N, 4)) {
    tile_matmul4_t(A, lda, static_cast<const float*>(w.w), K, N, rows, epi);
    return;
  }
  if (w.wtype == kWI8)
    tile_matmul_t(A, lda, static_cast<const int8_t*>(w.w), K, N, rows, epi);
  else if (w.wtype == kWI16)
    tile_matmul_t(A, lda, static_cast<const int16_t*>(w.w), K, N, rows, epi);
  else
    tile_matmul_t(A, lda, static_cast<const float*>(w.w), K, N, rows, epi);
}

__device__ inline float gelu_tanh(float y) {
  const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
  return 0.5f * y * (1.f + tanhf(u));
}

__device__ inline float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// Integer code of v on a frozen grid: round half to even, then clip.
__device__ inline float quant_code(float v, float s, float qmin, float qmax) {
  return fminf(fmaxf(rintf(v / s), qmin), qmax);
}

// The largest code of a symmetric `bits`-bit grid; the smallest is
// -grid_max - 1.
__device__ inline float grid_max(int bits) {
  return (float)((1 << (bits - 1)) - 1);
}

// v on the frozen (s, bits) grid: its code times s.
__device__ inline float requant(float v, float s, int bits) {
  const float qmax = grid_max(bits);
  return __fmul_rn(quant_code(v, s, -qmax - 1.f, qmax), s);
}

// The value of an integer dot from its plane accumulators (ops/intdot.py
// int16_dot): the code dot itself at 8 bits or fewer; else
// 256 * hi + (lo - 128) + 128 * colsum in one int32 (wrapping unsigned
// arithmetic: the true sum fits), or plane-wise with one f32 add.
__device__ inline float int_dot_value(int hi, int lo, int cs, int mode) {
  if (mode == kDotI8) return (float)lo;
  const unsigned low = (unsigned)lo + 128u * (unsigned)cs;
  if (mode == kDotI16) return (float)(int)((unsigned)hi * 256u + low);
  return __fadd_rn(__fmul_rn((float)hi, 256.f), (float)(int)low);
}

// Codes of rows [0, rows) x [0, K) of the float tile A (ld lda) on the
// grid (s, qmin, qmax) as the int8 planes of Q (ld ldq; the hi plane at Q,
// the lo plane at Q + kT * ldq): for kDotI8 the code itself in the lo
// plane. With `zd`, also code * s into zd[r * lda + c] (may be A itself).
// The integer code q at row r, column c of the code tile Q (ld ldq): the
// code itself in the lo plane (kDotI8), or its hi and lo planes.
__device__ inline void put_code(int8_t* Q, int ldq, int r, int c, int q,
                                int mode) {
  int8_t* Qlo = Q + kT * ldq;
  if (mode == kDotI8) {
    Qlo[r * ldq + c] = (int8_t)q;
  } else {
    Q[r * ldq + c] = (int8_t)(q >> 8);
    Qlo[r * ldq + c] = (int8_t)((q & 255) - 128);
  }
}

__device__ inline void quant_tile(const float* A, int lda, int K, int rows,
                                  float s, float qmin, float qmax, int mode,
                                  int8_t* Q, int ldq, float* zd) {
  for_tile(rows, K, [&](int r, int c) {
    const float code = quant_code(A[r * lda + c], s, qmin, qmax);
    put_code(Q, ldq, r, c, (int)code, mode);
    if (zd) zd[r * lda + c] = __fmul_rn(code, s);
  });
}

// out(r, c) = the integer dot of the codes in Q (ld ldq, planes as
// quant_tile writes them) with the int8 W (K, N) row-major, as a float
// through int_dot_value; per 4 k one packed weight word and one __dp4a per
// row and plane. `epi(r, c, value)` as for tile_matmul_t.
template <bool kTwo, class Epi>
__device__ inline void tile_matmul_q_t(const int8_t* Q, int ldq,
                                       const int8_t* __restrict__ W, int K,
                                       int N, int rows, int mode,
                                       const int* colsum, Epi epi) {
  const int8_t* Qlo = Q + kT * ldq;
  const int n_items = N * (kT / kRT);
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int c = item % N;
    const int r0 = (item / N) * kRT;
    if (r0 >= rows) continue;
    int hi[kRT], lo[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) hi[r] = lo[r] = 0;
    int k = 0;
#pragma unroll 2
    for (; k + 4 <= K; k += 4) {
      const unsigned w0 = (unsigned char)__ldg(W + (long long)(k + 0) * N + c);
      const unsigned w1 = (unsigned char)__ldg(W + (long long)(k + 1) * N + c);
      const unsigned w2 = (unsigned char)__ldg(W + (long long)(k + 2) * N + c);
      const unsigned w3 = (unsigned char)__ldg(W + (long long)(k + 3) * N + c);
      const int w4 = (int)(w0 | (w1 << 8) | (w2 << 16) | (w3 << 24));
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int off = (r0 + r) * ldq + k;
        lo[r] = __dp4a(*reinterpret_cast<const int*>(Qlo + off), w4, lo[r]);
        if (kTwo)
          hi[r] = __dp4a(*reinterpret_cast<const int*>(Q + off), w4, hi[r]);
      }
    }
    for (; k < K; ++k) {
      const int w = __ldg(W + (long long)k * N + c);
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        lo[r] += (int)Qlo[(r0 + r) * ldq + k] * w;
        if (kTwo) hi[r] += (int)Q[(r0 + r) * ldq + k] * w;
      }
    }
    const int cs = kTwo ? colsum[c] : 0;
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      if (r0 + r < rows) epi(r0 + r, c, int_dot_value(hi[r], lo[r], cs, mode));
  }
}

// tile_matmul_q_t with a register tile of kRT rows x 4 neighbouring
// columns a thread (N % 4 == 0, W 4-byte aligned): per 4 k one word of
// each of the four weight rows, transposed by byte permutes into one word
// per column, then one __dp4a per row, column and plane.
template <bool kTwo, class Epi>
__device__ inline void tile_matmul_q4_t(const int8_t* Q, int ldq,
                                        const int8_t* __restrict__ W, int K,
                                        int N, int rows, int mode,
                                        const int* colsum, Epi epi) {
  const int8_t* Qlo = Q + kT * ldq;
  const int n_cg = N / 4;
  const int n_items = n_cg * (kT / kRT);
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int c0 = (item % n_cg) * 4;
    const int r0 = (item / n_cg) * kRT;
    if (r0 >= rows) continue;
    int hi[kRT][4], lo[kRT][4];
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) hi[r][j] = lo[r][j] = 0;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      unsigned w[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        w[kk] = __ldg(reinterpret_cast<const unsigned*>(
            W + (long long)(k + kk) * N + c0));
      // col[j] = bytes (w[0].j, w[1].j, w[2].j, w[3].j): k ascending
      const unsigned t01l = __byte_perm(w[0], w[1], 0x5140);
      const unsigned t01h = __byte_perm(w[0], w[1], 0x7362);
      const unsigned t23l = __byte_perm(w[2], w[3], 0x5140);
      const unsigned t23h = __byte_perm(w[2], w[3], 0x7362);
      const int col[4] = {(int)__byte_perm(t01l, t23l, 0x5410),
                          (int)__byte_perm(t01l, t23l, 0x7632),
                          (int)__byte_perm(t01h, t23h, 0x5410),
                          (int)__byte_perm(t01h, t23h, 0x7632)};
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        const int off = (r0 + r) * ldq + k;
        const int ql = *reinterpret_cast<const int*>(Qlo + off);
#pragma unroll
        for (int j = 0; j < 4; ++j) lo[r][j] = __dp4a(ql, col[j], lo[r][j]);
        if (kTwo) {
          const int qh = *reinterpret_cast<const int*>(Q + off);
#pragma unroll
          for (int j = 0; j < 4; ++j) hi[r][j] = __dp4a(qh, col[j], hi[r][j]);
        }
      }
    }
    for (; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = __ldg(W + (long long)k * N + c0 + j);
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          lo[r][j] += (int)Qlo[(r0 + r) * ldq + k] * w;
          if (kTwo) hi[r][j] += (int)Q[(r0 + r) * ldq + k] * w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cs = kTwo ? colsum[c0 + j] : 0;
#pragma unroll
      for (int r = 0; r < kRT; ++r)
        if (r0 + r < rows)
          epi(r0 + r, c0 + j, int_dot_value(hi[r][j], lo[r][j], cs, mode));
    }
  }
}

template <class Epi>
__device__ inline void tile_matmul_q(const int8_t* Q, int ldq,
                                     const int8_t* W, int K, int N, int rows,
                                     int mode, const int* colsum, Epi epi) {
  if (wide_ok(W, N, 1)) {
    if (mode == kDotI8)
      tile_matmul_q4_t<false>(Q, ldq, W, K, N, rows, mode, colsum, epi);
    else
      tile_matmul_q4_t<true>(Q, ldq, W, K, N, rows, mode, colsum, epi);
    return;
  }
  if (mode == kDotI8)
    tile_matmul_q_t<false>(Q, ldq, W, K, N, rows, mode, colsum, epi);
  else
    tile_matmul_q_t<true>(Q, ldq, W, K, N, rows, mode, colsum, epi);
}

// acc -> the dense's output value at column c: the scale (the accumulator
// scale of an integer dot), the bias, then the output requant if any.
__device__ inline float dense_out(const DenseW& w, int c, float acc) {
  const float v = __fadd_rn(
      __fmul_rn(acc, w.in_mode ? w.acc_scale : w.scale), w.bias[c]);
  return w.out_bits ? requant(v, w.out_s, w.out_bits) : v;
}

// out(r, c) = A @ W through the dense w: the float dot of A, or with an
// input grid the integer dot of A's codes (quantized into Q first).
template <class Epi>
__device__ inline void dense_tile(const float* A, int lda, const DenseW& w,
                                  int K, int N, int rows, int8_t* Q, int ldq,
                                  Epi epi) {
  if (w.in_mode == kDotFloat) {
    tile_matmul(A, lda, w, K, N, rows, epi);
    return;
  }
  const float qmax = grid_max(w.in_bits);
  quant_tile(A, lda, K, rows, w.in_s, -qmax - 1.f, qmax, w.in_mode, Q, ldq,
             nullptr);
  __syncthreads();
  tile_matmul_q(Q, ldq, static_cast<const int8_t*>(w.w), K, N, rows,
                       w.in_mode, w.colsum, epi);
}

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// What the next reader of the stream sees of h: the requant grid value
// where the layer has an output requant, else h in the stream's type.
__device__ inline float stream_value(float h, const LayerParams& lp,
                                     int act_bf16) {
  if (lp.has_rq)
    return __fmul_rn(quant_code(h, lp.rq_s, lp.rq_min, lp.rq_max), lp.rq_s);
  return act_bf16 ? bf16_round(h) : h;
}

__device__ inline float load_io(const void* p, long long i, int type) {
  switch (type) {
    case kIoBF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case kIoI16:
      return (float)static_cast<const int16_t*>(p)[i];
    case kIoI8:
      return (float)static_cast<const int8_t*>(p)[i];
    default:
      return static_cast<const float*>(p)[i];
  }
}

__device__ inline void store_io(void* p, long long i, int type, float v) {
  switch (type) {
    case kIoBF16:
      static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
      break;
    case kIoI16:
      static_cast<int16_t*>(p)[i] = (int16_t)v;
      break;
    case kIoI8:
      static_cast<int8_t*>(p)[i] = (int8_t)v;
      break;
    default:
      static_cast<float*>(p)[i] = v;
  }
}

// 16 bytes from global to shared memory without a register, in flight
// until cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Whether float rows of `width` at `src` (row stride `ld`) go as 16-byte
// copies: whole units, every row's start aligned.
__device__ __forceinline__ bool rows_async_ok(const void* src, int ld,
                                              int width) {
  return width % 4 == 0 && ld % 4 == 0 &&
         ((unsigned long long)src & 15ull) == 0;
}

// The first `width` floats of rows [0, rows) at `src` (stride src_ld) into
// the shared tile T (stride ld) as 16-byte async copies, all issued at
// once; cp_async_wait and a barrier before they are read.
__device__ inline void rows_async(float* T, int ld, const float* src,
                                  long long src_ld, int width, int rows) {
  for_tile(rows, width / 4, [&](int r, int u) {
    cp_async16(T + r * ld + 4 * u, src + r * src_ld + 4 * u);
  });
}

// Rows [t0, t0 + rows) of a (L, width) row-major array of `type` into a
// shared tile with leading dimension ld, times `scale`.
__device__ inline void load_tile(float* T, int ld, const void* src, int type,
                                 long long row0, int width, int rows,
                                 float scale) {
  for_tile(rows, width, [&](int r, int c) {
    T[r * ld + c] = __fmul_rn(load_io(src, (row0 + r) * width + c, type),
                              scale);
  });
}

// Encoder: R = stream_type(relu?(requant?((X @ W_enc) * s + b))).
__device__ inline void encode_tile(const float* X, int ldx, const DenseW& enc,
                                   int d_in, const Mode& m, float* R, int ldh,
                                   int rows, int8_t* Q, int ldq) {
  dense_tile(X, ldx, enc, d_in, m.h, rows, Q, ldq,
             [&](int r, int c, float acc) {
               float v = dense_out(enc, c, acc);
               if (m.relufication) v = fmaxf(v, 0.f);
               R[r * ldh + c] = m.act_bf16 ? bf16_round(v) : v;
             });
}

// Decoder: out[t0 + r, c] = requant?((R @ W_dec) * s + b), as `out_type`.
__device__ inline void decode_tile(const float* R, int ldh, const DenseW& dec,
                                   int h, int d_out, void* out, int out_type,
                                   long long row0, int rows, int8_t* Q,
                                   int ldq) {
  dense_tile(R, ldh, dec, h, d_out, rows, Q, ldq,
             [&](int r, int c, float acc) {
               store_io(out, (row0 + r) * d_out + c, out_type,
                        dense_out(dec, c, acc));
             });
}

// The B-projection of the S5 mixer on a tile Z (rows x H, the mixer
// input): bu = (Z @ W_b) * (per-half scale), then quant_but; `out(r, c, v)`
// consumes bu. In the mixer_in16 mode the dot runs on the codes of Z (the
// planes in Q, ld ldq) and Z is overwritten with code * s, the D term's
// operand. The 4-column register tiles, as every dot of the passes.
template <class Out>
__device__ inline void mixer_bproj(const LayerParams& lp, int H, float* Z,
                                   int ldh, int rows, int8_t* Q, int ldq,
                                   Out out) {
  const int P = lp.p;
  auto bu_out = [&](int r, int c, float v) {
    if (lp.but_bits)
      v = requant(v, c < P ? lp.but_re : lp.but_im, lp.but_bits);
    out(r, c, v);
  };
  if (lp.ut_mode) {
    const float qmax = grid_max(lp.ut_bits);
    quant_tile(Z, ldh, H, rows, lp.ut_s, -qmax - 1.f, qmax, lp.ut_mode, Q,
               ldq, Z);
    __syncthreads();
    tile_matmul_q(Q, ldq, static_cast<const int8_t*>(lp.wb.w), H,
                         2 * P, rows, lp.ut_mode, lp.cs_wb,
                         [&](int r, int c, float acc) {
                    bu_out(r, c,
                           __fmul_rn(acc, c < P ? lp.ut_sc_re : lp.ut_sc_im));
                  });
  } else {
    tile_matmul(Z, ldh, lp.wb, H, 2 * P, rows,
                       [&](int r, int c, float acc) {
      bu_out(r, c, __fmul_rn(acc, c < P ? lp.wb_s_re : lp.wb_s_im));
    });
  }
}

// A state (xr, xi) on the frozen block-requant grid, or the state itself
// without one: (sr, si).
__device__ inline void mixer_grid(const LayerParams& lp, float xr, float xi,
                                  float& sr, float& si) {
  sr = xr;
  si = xi;
  if (lp.has_sq) {
    sr = __fmul_rn(quant_code(xr, lp.sq_re, lp.sq_min, lp.sq_max), lp.sq_re);
    si = __fmul_rn(quant_code(xi, lp.sq_im, lp.sq_min, lp.sq_max), lp.sq_im);
  }
}

// What the C-projection reads of a state on the grid (sr, si): relu, then
// the state times the C-side scale, or the state's code for the integer
// C-projection.
__device__ inline void mixer_read(const LayerParams& lp, int relu_state,
                                  float sr, float si, float& wr, float& wi) {
  if (relu_state) {
    sr = fmaxf(sr, 0.f);
    si = fmaxf(si, 0.f);
  }
  if (lp.st_mode) {
    wr = __fmul_rn(sr, lp.st_inv_re);
    wi = __fmul_rn(si, lp.st_inv_im);
  } else {
    wr = __fmul_rn(sr, lp.wc_s_re);
    wi = __fmul_rn(si, lp.wc_s_im);
  }
}

// The C-projection of the states (as mixer_read leaves them) + d * Z, then
// quant_yt, into Y: on S (rows x [re | im], ld ldp), or in the state16 mode
// one integer dot per half on the states' codes, which the caller put in
// Q (the re half's at column 0, the im half's at round4(P)).
__device__ inline void mixer_cproj(const LayerParams& lp, int H,
                                   const float* Z, float* Y, const float* S,
                                   int ldh, int ldp, int rows, int8_t* Q,
                                   int ldq) {
  const int P = lp.p;
  auto y_out = [&](int r, int c, float v) {
    float y = __fadd_rn(v, __fmul_rn(lp.d[c], Z[r * ldh + c]));
    if (lp.yt_bits) y = requant(y, lp.yt_s, lp.yt_bits);
    Y[r * ldh + c] = y;
  };
  if (lp.st_mode) {
    const int p4 = round4(P);
    const int8_t* wc = static_cast<const int8_t*>(lp.wc.w);
    tile_matmul_q(Q, ldq, wc, P, H, rows, lp.st_mode, lp.cs_wc_re,
                         [&](int r, int c, float acc) {
                    Y[r * ldh + c] = __fmul_rn(acc, lp.st_sc_re);
                  });
    __syncthreads();
    tile_matmul_q(Q + p4, ldq, wc + (long long)P * H, P, H, rows,
                         lp.st_mode, lp.cs_wc_im,
                         [&](int r, int c, float acc) {
                    y_out(r, c, __fadd_rn(Y[r * ldh + c],
                                          __fmul_rn(acc, lp.st_sc_im)));
                  });
  } else {
    tile_matmul(S, ldp, lp.wc, 2 * P, H, rows,
                       [&](int r, int c, float acc) { y_out(r, c, acc); });
  }
}

// z = r * nw + nb (prenorm) or r, on a tile: R -> Z.
__device__ inline void layer_norm(const LayerParams& lp, const Mode& m,
                                  const float* R, float* Z, int ldh,
                                  int rows) {
  const int H = m.h;
  for_tile(rows, H, [&](int r, int c) {
    const float v = R[r * ldh + c];
    Z[r * ldh + c] =
        m.prenorm ? __fadd_rn(__fmul_rn(v, lp.nw[c]), lp.nb[c]) : v;
  });
}

// The layer after its mixer, on a tile: x1 = act(Y) (replaces Z), the GLU
// (4-column register tiles), the residual R, the postnorm affine and
// relufication; h replaces R. Y may be overwritten (the full GLU's value
// dense).
__device__ inline void layer_finish(const LayerParams& lp, const Mode& m,
                                    float* R, float* Z, float* Y, int ldh,
                                    int rows, int8_t* Q, int ldq) {
  const int H = m.h;
  // ---- activation (x1 replaces z); no GLU: residual here ----
  for_tile(rows, H, [&](int r, int c) {
    const float y = Y[r * ldh + c];
    Z[r * ldh + c] = m.relufication ? fmaxf(y, 0.f) : gelu_tanh(y);
  });
  __syncthreads();
  auto finish = [&](int r, int c, float hval) {
    float o = __fadd_rn(hval, R[r * ldh + c]);
    if (!m.prenorm) o = __fadd_rn(__fmul_rn(o, lp.nw[c]), lp.nb[c]);
    if (m.relufication) o = fmaxf(o, 0.f);
    R[r * ldh + c] = o;
  };
  if (m.glu == kNone) {
    for_tile(rows, H, [&](int r, int c) { finish(r, c, Z[r * ldh + c]); });
    __syncthreads();
    return;
  }
  if (m.glu == kFull) {
    // value dense: Y = requant?((x1 @ W_1) * s_1 + b_1) (y is no longer
    // needed)
    dense_tile(Z, ldh, lp.out1, H, H, rows, Q, ldq,
               [&](int r, int c, float acc) {
                 Y[r * ldh + c] = dense_out(lp.out1, c, acc);
               });
    __syncthreads();
  }
  const float* base = m.glu == kHalf1 ? Z : Y;
  dense_tile(Z, ldh, lp.out2, H, H, rows, Q, ldq,
             [&](int r, int c, float acc) {
               const float gate = sigmoidf(dense_out(lp.out2, c, acc));
               finish(r, c, __fmul_rn(base[r * ldh + c], gate));
             });
  __syncthreads();
}

}  // namespace engine
