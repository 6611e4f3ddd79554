// Whole S5 layer after the norm, eval forward, one CTA per batch row:
//
//   z = x * nw + nb                      (BatchNorm folded to an affine)
//   xs = scan(lam, z @ W_b)              (complex diagonal recurrence)
//   y = [xs_re xs_im] @ W_c + D * z      (relu on xs if relu_state)
//   x1 = act(y)                          (gelu, tanh form, or relu)
//   h = GLU(x1, y)                       (full / half1 / half2 / none)
//   out = h + x                          (relu if layer_relu)
//
// Replaces the TPU kernel sparsernns_tpu/ops/pallas/fused_layer_train.py
// `fused_layer_tail` (pallas_call at :293, body `_make_tail_kernel` :69) in
// affine mode without dropout masks. On the TPU the grid walks time blocks
// of a batch row in order with the carry in VMEM scratch. CUDA blocks run
// in no order, so here one CTA owns one batch row and loops over time
// tiles of kT rows itself, the carry in shared memory.
//
// Per tile: the raw rows x, the normed rows z, the states and y live in
// shared memory (kT*(3H + 2P) floats, 107 KB at H=192, P=128); nothing but
// x and out touches device memory. The four weights (W_b, W_c: H*2P each,
// W2 and W1: H*H, 0.5 MB in f32 at the serving width) do not fit in shared
// memory beside the tile, so every product streams its weight from L2
// (coalesced along the output column, each thread keeping kRT rows of
// accumulators; the A operand is a broadcast float4 shared-memory read).
// The products are plain f32 FMA on the CUDA cores, no tensor cores: the
// layer is held to f32 accuracy.
//
// Bound: operations. Per row 2*H*2P (B-proj) + 2*2P*H (C-proj) + 2*H*H
// per GLU dense, about 0.27 MFLOP at H=192, P=128 with half1; at B=8,
// L=3751 that is 8.1 GFLOP, 0.12 ms at the card's 67 TFLOP/s f32 peak,
// against 46 MB of device memory traffic (x read, out written, weights),
// 0.014 ms at 3.35 TB/s.
//
// Limits of this simple design: B CTAs in all (8 at B=8) fill B of the
// 132 SMs, so the kernel runs at most B/132 of the card's peak; within an
// SM it is bound by shared-memory reads and L2 weight streaming. Splitting
// a row's state channels over a thread-block cluster (reducing the
// C-projection through distributed shared memory) is the way to more SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;        // time rows per tile
constexpr int kRT = 8;        // accumulator rows per thread
constexpr int kThreads = 256;

enum Glu { kFull = 0, kHalf1 = 1, kHalf2 = 2, kNone = 3 };

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// out(r, c) = sum_k A[r*lda + k] * W[k*N + c] for the first `rows` rows of
// the tile; `epi(r, c, acc)` consumes each result. A lives in shared
// memory with lda % 4 == 0; W (K, N) row-major in device memory.
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

__device__ inline float act_fn(float y, int act) {
  if (act == 1) return fmaxf(y, 0.f);
  // jax.nn.gelu's default tanh approximation
  const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
  return 0.5f * y * (1.f + tanhf(u));
}

__global__ void __launch_bounds__(kThreads)
layer_tail_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const float* __restrict__ nw, const float* __restrict__ nb,
                  const float* __restrict__ wb, const float* __restrict__ wc,
                  const float* __restrict__ dvec,
                  const float* __restrict__ lam_re,
                  const float* __restrict__ lam_im,
                  const float* __restrict__ o2k,
                  const float* __restrict__ o2b,
                  const float* __restrict__ o1k,
                  const float* __restrict__ o1b, int L, int H, int P,
                  int glu, int act, int relu_state, int layer_relu) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldh = round4(H);
  const int ldp = round4(2 * P);
  float* X = smem;                 // raw rows (the residual)
  float* Z = X + kT * ldh;         // normed rows, later x1 = act(y)
  float* Y = Z + kT * ldh;         // y, later the "full" GLU base
  float* S = Y + kT * ldh;         // bu, then the states [re | im]
  float* carry = S + kT * ldp;     // (2P) carry [re | im] across tiles

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xb = x + (long long)b * L * H;
  float* ob = out + (long long)b * L * H;

  for (int p = tid; p < 2 * P; p += blockDim.x) carry[p] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kT) {
    const int rows = min(kT, L - t0);
    // ---- load the tile and apply the norm affine ----
    for (int i = tid; i < kT * H; i += blockDim.x) {
      const int r = i / H, c = i % H;
      const float v = r < rows ? xb[(long long)(t0 + r) * H + c] : 0.f;
      X[r * ldh + c] = v;
      Z[r * ldh + c] = r < rows ? fmaf(v, nw[c], nb[c]) : 0.f;
    }
    __syncthreads();
    // ---- B-projection: S = Z @ W_b ----
    tile_matmul(Z, ldh, wb, H, 2 * P, rows,
                [&](int r, int c, float acc) { S[r * ldp + c] = acc; });
    __syncthreads();
    // ---- in-order scan over the tile, carry in shared memory ----
    for (int p = tid; p < P; p += blockDim.x) {
      const float lr = lam_re[p], li = lam_im[p];
      float xr = carry[p], xi = carry[P + p];
      for (int r = 0; r < rows; ++r) {
        const float nr = lr * xr - li * xi + S[r * ldp + p];
        const float ni = lr * xi + li * xr + S[r * ldp + P + p];
        xr = nr;
        xi = ni;
        S[r * ldp + p] = relu_state ? fmaxf(xr, 0.f) : xr;
        S[r * ldp + P + p] = relu_state ? fmaxf(xi, 0.f) : xi;
      }
      carry[p] = xr;
      carry[P + p] = xi;
    }
    __syncthreads();
    // ---- C-projection + D * z: Y = S @ W_c + d * Z ----
    tile_matmul(S, ldp, wc, 2 * P, H, rows, [&](int r, int c, float acc) {
      Y[r * ldh + c] = fmaf(dvec[c], Z[r * ldh + c], acc);
    });
    __syncthreads();
    // ---- activation (x1 replaces z); no GLU: residual and store ----
    for (int i = tid; i < rows * H; i += blockDim.x) {
      const int r = i / H, c = i % H;
      const float x1 = act_fn(Y[r * ldh + c], act);
      if (glu == kNone) {
        float o = x1 + X[r * ldh + c];
        if (layer_relu) o = fmaxf(o, 0.f);
        ob[(long long)(t0 + r) * H + c] = o;
      } else {
        Z[r * ldh + c] = x1;
      }
    }
    __syncthreads();
    if (glu != kNone) {
      if (glu == kFull) {
        // value dense: Y = x1 @ W1 + b1 (y itself is no longer needed)
        tile_matmul(Z, ldh, o1k, H, H, rows, [&](int r, int c, float acc) {
          Y[r * ldh + c] = acc + o1b[c];
        });
        __syncthreads();
      }
      const float* base = glu == kHalf1 ? Z : Y;
      // gate dense, sigmoid, gating, residual, store
      tile_matmul(Z, ldh, o2k, H, H, rows, [&](int r, int c, float acc) {
        const float gate = 1.f / (1.f + expf(-(acc + o2b[c])));
        float o = fmaf(base[r * ldh + c], gate, X[r * ldh + c]);
        if (layer_relu) o = fmaxf(o, 0.f);
        ob[(long long)(t0 + r) * H + c] = o;
      });
      __syncthreads();
    }
  }
}

}  // namespace

// x, out: (B, L, H) contiguous. nw, nb, d, o2b, o1b: (H). wb: (H, 2P);
// wc: (2P, H), conj-sym factor folded in; o2k, o1k: (H, H) in (in, out)
// layout, null when the GLU variant does not use them. lam_re, lam_im: (P).
// glu: 0 full, 1 half1, 2 half2, 3 none; act: 0 gelu, 1 relu. Returns
// cudaGetLastError() after the launch.
extern "C" int layer_tail_fwd(
    const float* x, float* out, const float* nw, const float* nb,
    const float* wb, const float* wc, const float* d, const float* lam_re,
    const float* lam_im, const float* o2k, const float* o2b,
    const float* o1k, const float* o1b, int B, int L, int H, int P, int glu,
    int act, int relu_state, int layer_relu, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kT * (3 * round4(H) + round4(2 * P)) + 2 * P);
  cudaError_t err = cudaFuncSetAttribute(
      layer_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  layer_tail_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      x, out, nw, nb, wb, wc, d, lam_re, lam_im, o2k, o2b, o1k, o1b, L, H, P,
      glu, act, relu_state, layer_relu);
  return (int)cudaGetLastError();
}
