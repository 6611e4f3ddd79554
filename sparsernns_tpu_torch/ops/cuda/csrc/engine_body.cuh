// Shared device code of the serving-engine kernels: one quantized serving
// layer (and the encoder / decoder dense) on a tile of kT frames of one
// batch row, held in shared memory. Included by engine_layer.cu (one layer
// per launch, optional carry) and engine_network.cu (the whole network per
// launch). Both kernels compute every product and every requantization
// through the functions below, with each output element summed over k in
// ascending order by fmaf, so the two routes give bit-identical results.
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
// The result h (before the output requant) replaces r in shared memory.
// Rounding is round-half-to-even (rintf) with the clip after it; scales
// divide, as in the reference. No fast-math intrinsics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_step.cuh"

namespace engine {

constexpr int kT = 32;        // frames per tile
constexpr int kRT = 8;        // accumulator rows per thread
constexpr int kThreads = 256;

enum Glu { kFull = 0, kHalf1 = 1, kHalf2 = 2, kNone = 3 };
enum WType { kWF32 = 0, kWI8 = 1, kWI16 = 2 };
enum IoType { kIoF32 = 0, kIoBF16 = 1, kIoI16 = 2, kIoI8 = 3 };

// A dense weight (K, N) row-major with its per-tensor scale and bias.
struct DenseW {
  const void* w;
  const float* bias;   // (N) or null
  float scale;         // 1 when the weight is float
  int wtype;           // WType
};

// One layer's operands. The layout is mirrored by a ctypes.Structure in
// ops/cuda/engine_layer.py: pointers first, then 4-byte fields.
struct LayerParams {
  const float* lam_re;   // (P)
  const float* lam_im;
  const float* d;        // (H)
  const float* nw;       // (H)
  const float* nb;
  DenseW wb;             // (H, 2P) [B_re^T | B_im^T]
  DenseW wc;             // (2P, H) [C_re^T ; -C_im^T]
  DenseW out2;           // (H, H) gate dense, w null without a GLU
  DenseW out1;           // (H, H) value dense of the "full" GLU
  float wb_s_re, wb_s_im;      // per-half weight scales (1 if float)
  float wc_s_re, wc_s_im;      // incl. the conj-sym factor 2
  float sq_re, sq_im, sq_min, sq_max;   // block state requant grid
  float rq_s, rq_min, rq_max;           // output (residual) requant grid
  int has_sq, has_rq;
  int p;
};

struct Mode {
  int h, prenorm, relufication, glu, relu_state, act_bf16;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

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

template <class Epi>
__device__ inline void tile_matmul(const float* A, int lda, const DenseW& w,
                                   int K, int N, int rows, Epi epi) {
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

// Rows [t0, t0 + rows) of a (L, width) row-major array of `type` into a
// shared tile with leading dimension ld, times `scale`.
__device__ inline void load_tile(float* T, int ld, const void* src, int type,
                                 long long row0, int width, int rows,
                                 float scale) {
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
    const int r = i / width, c = i % width;
    T[r * ld + c] = __fmul_rn(load_io(src, (row0 + r) * width + c, type),
                              scale);
  }
}

// Encoder: R = stream_type(relu?((X @ W_enc) * s + b)).
__device__ inline void encode_tile(const float* X, int ldx, const DenseW& enc,
                                   int d_in, const Mode& m, float* R, int ldh,
                                   int rows) {
  tile_matmul(X, ldx, enc, d_in, m.h, rows, [&](int r, int c, float acc) {
    float v = __fadd_rn(__fmul_rn(acc, enc.scale), enc.bias[c]);
    if (m.relufication) v = fmaxf(v, 0.f);
    R[r * ldh + c] = m.act_bf16 ? bf16_round(v) : v;
  });
}

// Decoder: out[t0 + r, c] = (R @ W_dec) * s + b, stored as `out_type`.
__device__ inline void decode_tile(const float* R, int ldh, const DenseW& dec,
                                   int h, int d_out, void* out, int out_type,
                                   long long row0, int rows) {
  tile_matmul(R, ldh, dec, h, d_out, rows, [&](int r, int c, float acc) {
    store_io(out, (row0 + r) * d_out + c, out_type,
             __fadd_rn(__fmul_rn(acc, dec.scale), dec.bias[c]));
  });
}

// The S5 mixer on a tile: Z (rows x H, the mixer input) -> Y = the mixer
// output. S: (kT, ldp) scratch, ldp >= 2P; carry: (2P) running state
// [re | im] of this layer, kept across tiles. `t0` is the index of the
// tile's first frame in the sequence of length L. Shared by the layer
// (layer_tile) and the stand-alone mixer kernel (fused_s5.cu), so
// both round every product, state and requant alike.
__device__ inline void mixer_tile(const LayerParams& lp, int relu_state,
                                  int H, const float* Z, float* Y, float* S,
                                  float* carry, int ldh, int ldp, int rows,
                                  int t0, int L, int block_t) {
  const int P = lp.p;
  const int tid = threadIdx.x;
  // ---- B-projection, per-half weight scale on the result ----
  tile_matmul(Z, ldh, lp.wb, H, 2 * P, rows, [&](int r, int c, float acc) {
    S[r * ldp + c] = __fmul_rn(acc, c < P ? lp.wb_s_re : lp.wb_s_im);
  });
  __syncthreads();
  // ---- recurrence in order, block requant, relu and C-side scale ----
  for (int p = tid; p < P; p += blockDim.x) {
    const float lr = lp.lam_re[p], li = lp.lam_im[p];
    float xr = carry[p], xi = carry[P + p];
    for (int r = 0; r < rows; ++r) {
      scan::scan_step_rn(lr, li, S[r * ldp + p], S[r * ldp + P + p], xr,
                         xi);
      float sr = xr, si = xi;
      if (lp.has_sq) {
        sr = __fmul_rn(quant_code(xr, lp.sq_re, lp.sq_min, lp.sq_max),
                       lp.sq_re);
        si = __fmul_rn(quant_code(xi, lp.sq_im, lp.sq_min, lp.sq_max),
                       lp.sq_im);
        const int t = t0 + r + 1;
        if (t % block_t == 0 || t == L) {   // the block ends: carry on grid
          xr = sr;
          xi = si;
        }
      }
      if (relu_state) {
        sr = fmaxf(sr, 0.f);
        si = fmaxf(si, 0.f);
      }
      S[r * ldp + p] = __fmul_rn(sr, lp.wc_s_re);
      S[r * ldp + P + p] = __fmul_rn(si, lp.wc_s_im);
    }
    carry[p] = xr;
    carry[P + p] = xi;
  }
  __syncthreads();
  // ---- C-projection + D * z ----
  tile_matmul(S, ldp, lp.wc, 2 * P, H, rows, [&](int r, int c, float acc) {
    Y[r * ldh + c] = __fadd_rn(acc, __fmul_rn(lp.d[c], Z[r * ldh + c]));
  });
  __syncthreads();
}

// One layer on the tile R (rows x H, f32 stream values); h replaces R.
// Z, Y: (kT, ldh) scratch; S, carry, t0 as for mixer_tile.
__device__ inline void layer_tile(const LayerParams& lp, const Mode& m,
                                  float* R, float* Z, float* Y, float* S,
                                  float* carry, int ldh, int ldp, int rows,
                                  int t0, int L, int block_t) {
  const int H = m.h;
  const int tid = threadIdx.x;
  for (int i = tid; i < rows * H; i += blockDim.x) {
    const int r = i / H, c = i % H;
    const float v = R[r * ldh + c];
    Z[r * ldh + c] =
        m.prenorm ? __fadd_rn(__fmul_rn(v, lp.nw[c]), lp.nb[c]) : v;
  }
  __syncthreads();
  mixer_tile(lp, m.relu_state, H, Z, Y, S, carry, ldh, ldp, rows, t0, L,
             block_t);
  // ---- activation (x1 replaces z); no GLU: residual here ----
  for (int i = tid; i < rows * H; i += blockDim.x) {
    const int r = i / H, c = i % H;
    const float y = Y[r * ldh + c];
    Z[r * ldh + c] = m.relufication ? fmaxf(y, 0.f) : gelu_tanh(y);
  }
  __syncthreads();
  auto finish = [&](int r, int c, float hval) {
    float o = __fadd_rn(hval, R[r * ldh + c]);
    if (!m.prenorm) o = __fadd_rn(__fmul_rn(o, lp.nw[c]), lp.nb[c]);
    if (m.relufication) o = fmaxf(o, 0.f);
    R[r * ldh + c] = o;
  };
  if (m.glu == kNone) {
    for (int i = tid; i < rows * H; i += blockDim.x)
      finish(i / H, i % H, Z[(i / H) * ldh + i % H]);
    __syncthreads();
    return;
  }
  if (m.glu == kFull) {
    // value dense: Y = (x1 @ W_1) * s_1 + b_1 (y is no longer needed)
    tile_matmul(Z, ldh, lp.out1, H, H, rows, [&](int r, int c, float acc) {
      Y[r * ldh + c] =
          __fadd_rn(__fmul_rn(acc, lp.out1.scale), lp.out1.bias[c]);
    });
    __syncthreads();
  }
  const float* base = m.glu == kHalf1 ? Z : Y;
  tile_matmul(Z, ldh, lp.out2, H, H, rows, [&](int r, int c, float acc) {
    const float gate = sigmoidf(
        __fadd_rn(__fmul_rn(acc, lp.out2.scale), lp.out2.bias[c]));
    finish(r, c, __fmul_rn(base[r * ldh + c], gate));
  });
  __syncthreads();
}

}  // namespace engine
