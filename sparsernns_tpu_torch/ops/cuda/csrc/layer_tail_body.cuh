// Device functions shared by the whole-layer tail kernels: the forward
// (layer_tail.cu), the carry history and the adjoint (layer_tail_bwd.cu).
// The adjoint recomputes the forward chain from the history's states, and
// its relu / layer-relu / gate decisions must equal the forward's, so
// every elementwise step of that chain is one function here, written with
// explicit fmaf / __fmul_rn so that no kernel contracts it differently;
// the adjoint's products sum as tile_matmul does (one fmaf chain in
// ascending k).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_step.cuh"

namespace tail {

constexpr int kT = 32;        // time rows per tile
constexpr int kRT = 8;        // accumulator rows per thread
constexpr int kThreads = 256;

enum Glu { kFull = 0, kHalf1 = 1, kHalf2 = 2, kNone = 3 };

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// out(r, c) = sum_k A[r*lda + k] * W[k*N + c] for the first `rows` rows of
// the tile; `epi(r, c, acc)` consumes each result. A lives in shared
// memory with lda % 4 == 0; W (K, N) row-major in device memory. One thread
// owns one (row group, column) item, so two calls with the same N and rows
// give an output element to the same thread.
template <class Epi>
__device__ inline void tile_matmul(const float* A, int lda,
                                   const float* __restrict__ W, int K, int N,
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
      const float w0 = __ldg(W + (long long)(k + 0) * N + c);
      const float w1 = __ldg(W + (long long)(k + 1) * N + c);
      const float w2 = __ldg(W + (long long)(k + 2) * N + c);
      const float w3 = __ldg(W + (long long)(k + 3) * N + c);
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
      const float w = __ldg(W + (long long)k * N + c);
#pragma unroll
      for (int r = 0; r < kRT; ++r) acc[r] = fmaf(a[r * lda + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r)
      if (r0 + r < rows) epi(r0 + r, c, acc[r]);
  }
}

// jax.nn.gelu's default tanh approximation, or relu
__device__ inline float act_fn(float y, int act) {
  if (act == 1) return fmaxf(y, 0.f);
  const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
  return 0.5f * y * (1.f + tanhf(u));
}

// d act / d y of the same two forms
__device__ inline float act_grad(float y, int act) {
  if (act == 1) return y > 0.f ? 1.f : 0.f;
  const float k = 0.7978845608028654f;
  const float th = tanhf(k * (y + 0.044715f * y * y * y));
  return 0.5f * (1.f + th) +
         0.5f * y * (1.f - th * th) * k * (1.f + 3.f * 0.044715f * y * y);
}

// x1 after the first dropout mask (mask null: none)
__device__ inline float x1_dropped(float y, int act, const float* m1, int c) {
  const float x1 = act_fn(y, act);
  return m1 ? __fmul_rn(x1, m1[c]) : x1;
}

__device__ inline float sigmoid_fn(float s) { return 1.f / (1.f + expf(-s)); }

// the layer output before the layer relu: base * gate (* m2) + x
__device__ inline float gated_out(float base, float gate, const float* m2,
                                  int c, float x) {
  if (!m2) return fmaf(base, gate, x);
  return fmaf(__fmul_rn(base, gate), m2[c], x);
}

// Element i of a (B, L, H) stream stored as float32 (bf16 == 0) or bfloat16;
// a bf16 value widens to f32 exactly.
__device__ inline float load_stream(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// Store v into element i of a stream, rounded once to its type (round to
// nearest even, as the JAX kernels' `astype` rounds).
__device__ inline void store_stream(void* p, long long i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// Load rows [t0, t0 + rows) of one batch row (element offset `row0` in the
// streams) into Z, the normed rows, and X, the residual rows (X may be
// null); rows past the end are zero. Affine mode (nw given): `zs` holds the
// raw x, z = x * nw + nb and the residual is x itself. Non-affine mode (nw
// null): `zs` holds the normed z and `skip` the residual.
__device__ inline void load_tile(const void* zs, const void* skip,
                                 long long row0, int bf16, int t0, int rows,
                                 int H, int ldh,
                                 const float* __restrict__ nw,
                                 const float* __restrict__ nb, float* X,
                                 float* Z) {
  for (int i = threadIdx.x; i < kT * H; i += blockDim.x) {
    const int r = i / H, c = i % H;
    const long long at = row0 + (long long)(t0 + r) * H + c;
    const float v = r < rows ? load_stream(zs, at, bf16) : 0.f;
    if (nw) {
      if (X) X[r * ldh + c] = v;
      Z[r * ldh + c] = r < rows ? fmaf(v, nw[c], nb[c]) : 0.f;
    } else {
      if (X) X[r * ldh + c] = r < rows ? load_stream(skip, at, bf16) : 0.f;
      Z[r * ldh + c] = v;
    }
  }
}

// One step of x_t = lam * x_{t-1} + bu_t on a complex state (scan_step.cuh).
using scan::scan_step;

// In-order scan over a tile held in S as [re | im] columns (bu in, states
// out), from and to `carry` (2P floats in shared memory). With `act` the
// states after the mixer relu go to `act`, the raw states stay in S; with
// `relu_in_place` the relu is applied to S itself.
__device__ inline void scan_tile(float* S, int ldp, int P, int rows,
                                 const float* __restrict__ lam_re,
                                 const float* __restrict__ lam_im,
                                 float* carry, bool relu_in_place,
                                 float* act) {
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float lr = lam_re[p], li = lam_im[p];
    float xr = carry[p], xi = carry[P + p];
    for (int r = 0; r < rows; ++r) {
      scan_step(lr, li, S[r * ldp + p], S[r * ldp + P + p], xr, xi);
      S[r * ldp + p] = relu_in_place ? fmaxf(xr, 0.f) : xr;
      S[r * ldp + P + p] = relu_in_place ? fmaxf(xi, 0.f) : xi;
      if (act) {
        act[r * ldp + p] = fmaxf(xr, 0.f);
        act[r * ldp + P + p] = fmaxf(xi, 0.f);
      }
    }
    carry[p] = xr;
    carry[P + p] = xi;
  }
}

}  // namespace tail
