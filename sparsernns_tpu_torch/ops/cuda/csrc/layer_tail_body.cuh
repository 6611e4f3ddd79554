// Device code shared by the whole-layer tail kernels: the forward K2
// (layer_tail.cu) and the backward K3a / K3b (layer_tail_bwd.cu). Both run
// as passes over the whole card, on the B*L time rows of the (B, L, .)
// arrays:
//
//   tail_hist_bproj_kernel  bu = z @ W_b into S, z = x*nw + nb (affine) or
//                           the z stream; one CTA per (64 columns, chunk of
//                           kBM rows of one batch row).
//   tail_hist_scan_kernel   x_t = lam x_{t-1} + bu_t in place over S per
//                           (batch row, channel), the whole length in order
//                           with scan_step (scan_step.cuh); K3a also keeps
//                           the state entering every kT-row tile (the
//                           history), K2 passes no history.
//
// K2 launches the two, then its tail pass; K3a is the two, and K3b
// recomputes the forward chain from K3a's states. The backward's relu /
// layer-relu / gate decisions must equal the forward's, so every product is
// `gemm_tile` (each output one fmaf chain over k in ascending order from
// 0) and every elementwise step of the chain is one function here, written
// with explicit fmaf / __fmul_rn so that no kernel contracts it
// differently.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_step.cuh"

namespace tail {

constexpr int kT = 32;    // time rows of a history tile
constexpr int kBM = 128;  // rows of a product tile: a chunk of time rows
constexpr int kBN = 64;   // columns of a product tile
constexpr int kBK = 8;    // depth of one shared-memory stage
constexpr int kGT = 128;  // threads of a product CTA: 16 x 8, 8x8 outputs each
constexpr int kMinCtas = 3;  // product CTAs an SM holds at once (<= 168 regs)
constexpr int kLdB = kBN + 4;
constexpr int kScanT = 32;  // threads (state channels) of a scan CTA

enum Glu { kFull = 0, kHalf1 = 1, kHalf2 = 2, kNone = 3 };

// The two shared-memory stages of a product tile of kRows rows.
template <int kRows>
struct GemmSmemT {
  float a[2][kBK][kRows + 4];
  float b[2][kBK][kLdB];
};
using GemmSmem = GemmSmemT<kBM>;

// The product's stages, then its accumulator tile for the epilogue.
union TileSmem {
  GemmSmem g;
  float c[kBM][kBN + 4];
};

// acc[i][j] = sum_k A(ty*R + i, k) * Bm(k, n_j) for this thread's R x 8
// outputs of a kRows x kBN CTA tile (R = kRows / 16: 8 at the K3 passes'
// 128 rows, 4 at K2's tail tile of 64), ty = tid / 8, tx = tid % 8, n_j =
// tx*4 + j and, for j >= 4, 32 + tx*4 + j - 4 (a warp's shared-memory
// reads of B and stores of the tile are then free of bank conflicts);
// fa(m, k) and fb(k, n) give the operands, 0 outside their ranges. Each
// output is one fmaf chain over k in ascending order from 0. kRowA: A(m,
// k) runs along k in memory (a row of a (rows, K) array), so consecutive
// threads fetch consecutive k; otherwise A runs along m (a row of a (rows,
// M) array with k the row). Ends with the shared memory free for the
// caller.
template <bool kRowA, int kRows, class FA, class FB>
__device__ __forceinline__ void gemm_tile(int K, const FA& fa, const FB& fb,
                                          GemmSmemT<kRows>& sm,
                                          float (&acc)[kRows / 16][8]) {
  constexpr int kR = kRows / 16;
  constexpr int kNA = kRows * kBK / kGT;
  constexpr int kNB = kBK * kBN / kGT;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  float ra[kNA], rb[kNB];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kNA; ++i) {
      const int e = i * kGT + tid;
      const int m = kRowA ? e / kBK : e % kRows;
      const int k = kRowA ? e % kBK : e / kRows;
      ra[i] = fa(m, k0 + k);
    }
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      const int e = i * kGT + tid;
      rb[i] = fb(k0 + e / kBN, e % kBN);
    }
  };
  auto stash = [&](int s) {
#pragma unroll
    for (int i = 0; i < kNA; ++i) {
      const int e = i * kGT + tid;
      const int m = kRowA ? e / kBK : e % kRows;
      const int k = kRowA ? e % kBK : e / kRows;
      sm.a[s][k][m] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < kNB; ++i) {
      const int e = i * kGT + tid;
      sm.b[s][e / kBN][e % kBN] = rb[i];
    }
  };
  const int n_k = (K + kBK - 1) / kBK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < n_k) fetch((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kR];
#pragma unroll
      for (int q = 0; q < kR; q += 4) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(&sm.a[s][kk][ty * kR + q]);
        av[q] = a4.x;
        av[q + 1] = a4.y;
        av[q + 2] = a4.z;
        av[q + 3] = a4.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[s][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sm.b[s][kk][32 + tx * 4]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < n_k) stash(s ^ 1);
    __syncthreads();
  }
}

// The epilogue of a product tile: the threads' 8x8 accumulators go to
// shared memory, then epi(m, c, value) runs for every element of the
// first `rows` rows and `cols` columns in row order, thread t on column
// t % kBN of rows t / kBN, t / kBN + 2, ...: a warp reads and writes 32
// consecutive elements of a row. Every thread of the CTA calls it.
template <class Epi>
__device__ __forceinline__ void tile_epilogue(const float (&acc)[8][8],
                                              TileSmem& sm, int rows,
                                              int cols, const Epi& epi) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<float4*>(&sm.c[ty * 8 + i][tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&sm.c[ty * 8 + i][32 + tx * 4]) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  const int c = threadIdx.x % kBN;
  if (c < cols)
    for (int m = threadIdx.x / kBN; m < rows; m += kGT / kBN)
      epi(m, c, sm.c[m][c]);
  __syncthreads();
}

// out[c] = the sum over the tile's rows of a column's partials, which the
// kGT / kBN = 2 threads of column c hold (`v`), in a fixed order. Every
// thread of the CTA calls it, after tile_epilogue.
__device__ inline void tile_col_sum(float v, TileSmem& sm,
                                    float* __restrict__ out, int cols) {
  float* red = &sm.c[0][0];
  red[threadIdx.x] = v;
  __syncthreads();
  if ((int)threadIdx.x < cols)
    out[threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + kBN];
  __syncthreads();
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

// One step of x_t = lam * x_{t-1} + bu_t on a complex state (scan_step.cuh).
using scan::scan_step;

// A chunk of time rows: `rows` rows of batch row b from element row `row0`
// of the (B*L, .) arrays.
struct Chunk {
  long long row0;
  int rows, b;
};

__device__ inline Chunk chunk_of(int ci, int L, int cpr) {
  const int b = ci / cpr, t0 = (ci % cpr) * kBM;
  return {(long long)b * L + t0, min(kBM, L - t0), b};
}

// Loads of `kU` consecutive steps of one channel's re and im columns of a
// (L, 2P) slice, rows t0 + u * step (0 outside [0, L)).
template <int kU>
__device__ inline void fetch_steps(const float* __restrict__ s, int P, int L,
                                   int p, int t0, int step, float (&re)[kU],
                                   float (&im)[kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int t = t0 + u * step;
    const bool in = t >= 0 && t < L;
    re[u] = in ? s[(long long)t * 2 * P + p] : 0.f;
    im[u] = in ? s[(long long)t * 2 * P + P + p] : 0.f;
  }
}

// ---------------------------------------------------------------- passes

// S: (B*L, 2P) f32; x: (B, L, H), the raw input with nw, nb (affine) or
// the normed z with nw = nb = null; cpr: chunks of kBM rows per batch row
__global__ void __launch_bounds__(kGT, kMinCtas)
tail_hist_bproj_kernel(const void* __restrict__ x,
                       const float* __restrict__ nw,
                       const float* __restrict__ nb,
                       const float* __restrict__ wb, float* __restrict__ S,
                       int L, int H, int P, int bf16, int cpr) {
  __shared__ __align__(16) TileSmem sm;
  const Chunk ch = chunk_of(blockIdx.y, L, cpr);
  const int N = 2 * P, n0 = blockIdx.x * kBN;
  auto fa = [&](int m, int k) -> float {
    if (m >= ch.rows || k >= H) return 0.f;
    const float v = load_stream(x, (ch.row0 + m) * H + k, bf16);
    return nw ? fmaf(v, nw[k], nb[k]) : v;
  };
  auto fb = [&](int k, int n) -> float {
    return k < H && n0 + n < N ? __ldg(wb + (long long)k * N + n0 + n) : 0.f;
  };
  float acc[8][8];
  gemm_tile<true>(H, fa, fb, sm.g, acc);
  tile_epilogue(acc, sm, ch.rows, min(kBN, N - n0),
                [&](int m, int c, float v) {
                  S[(ch.row0 + m) * N + n0 + c] = v;
                });
}

// hist_re, hist_im: (B, ceil(L / kT), P), the state entering every kT-row
// tile, or null (no history: K2)
__global__ void __launch_bounds__(kScanT)
tail_hist_scan_kernel(float* __restrict__ S, const float* __restrict__ lam_re,
                      const float* __restrict__ lam_im,
                      float* __restrict__ hist_re,
                      float* __restrict__ hist_im, int L, int P) {
  constexpr int kU = 32;
  const int groups = (P + kScanT - 1) / kScanT;
  const int b = blockIdx.x / groups;
  const int p = (blockIdx.x % groups) * kScanT + threadIdx.x;
  if (p >= P) return;
  const int n_tiles = (L + kT - 1) / kT;
  float* s = S + (long long)b * L * 2 * P;
  float* hr = hist_re ? hist_re + (long long)b * n_tiles * P + p : nullptr;
  float* hi = hist_im ? hist_im + (long long)b * n_tiles * P + p : nullptr;
  const float lr = lam_re[p], li = lam_im[p];
  float xr = 0.f, xi = 0.f;
  float cr[kU], ci[kU], nr[kU], ni[kU];
  fetch_steps<kU>(s, P, L, p, 0, 1, cr, ci);
  for (int t0 = 0; t0 < L; t0 += kU) {
    // the next steps' loads go out before this block's dependent chain
    if (t0 + kU < L) fetch_steps<kU>(s, P, L, p, t0 + kU, 1, nr, ni);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u;
      if (t < L) {
        if (hr && t % kT == 0) {
          hr[(long long)(t / kT) * P] = xr;
          hi[(long long)(t / kT) * P] = xi;
        }
        scan_step(lr, li, cr[u], ci[u], xr, xi);
        s[(long long)t * 2 * P + p] = xr;
        s[(long long)t * 2 * P + P + p] = xi;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      cr[u] = nr[u];
      ci[u] = ni[u];
    }
  }
}

// The kernels that one call launched, in launch order, with their grids'
// CTAs: the record that the *_launched entries hand the wrappers.
struct LaunchRecord {
  static constexpr int kMax = 16;
  const char* names[kMax];
  long long ctas[kMax];
  int n = 0;
  void add(const char* name, dim3 grid) {
    if (n < kMax) {
      names[n] = name;
      ctas[n++] = (long long)grid.x * grid.y * grid.z;
    }
  }
  // up to `cap` names and grid sizes into the caller's arrays; returns how
  // many kernels the call launched
  int read(const char** out_names, long long* out_ctas, int cap) const {
    for (int i = 0; i < n && i < cap; ++i) {
      out_names[i] = names[i];
      out_ctas[i] = ctas[i];
    }
    return n;
  }
};

}  // namespace tail
