// Whole S5 layer after the norm, forward (eval and training), one CTA per
// batch row:
//
//   z = x * nw + nb, res = x             (affine: BatchNorm folded)
//   z, res = the two streams z, skip     (non-affine: LayerNorm, outside)
//   xs = scan(lam, z @ W_b)              (complex diagonal recurrence)
//   y = [xs_re xs_im] @ W_c + D * z      (relu on xs if relu_state)
//   x1 = act(y) * m1                     (gelu, tanh form, or relu; dropout)
//   h = GLU(x1, y) * m2                  (full / half1 / half2 / none)
//   out = h + res                        (relu if layer_relu)
//
// m1, m2 are the training dropout masks, one (H) row per batch row, already
// scaled by 1/keep; a null pointer means no mask (eval), and then no
// arithmetic changes. The streams (x or z, skip, out) are float32 or
// bfloat16: a bf16 element widens to f32 on load, every step computes in
// f32, and the output rounds once at the store. Replaces the TPU kernel
// sparsernns_tpu/ops/pallas/fused_layer_train.py `fused_layer_tail`
// (pallas_call at :293, body `_make_tail_kernel` :69) in its affine and
// non-affine modes, on f32 and bf16 streams. The steps of the chain are the
// device functions of layer_tail_body.cuh, which the adjoint kernel
// (layer_tail_bwd.cu) recomputes with. On the TPU the grid walks time
// blocks of a batch row in order with the carry in VMEM scratch. CUDA
// blocks run in no order, so here one CTA owns one batch row and loops over
// time tiles of kT rows itself, the carry in shared memory.
//
// Per tile: the residual rows (x, or skip in non-affine mode), the normed
// rows z, the states and y live in shared memory (kT*(3H + 2P) floats,
// 107 KB at H=192, P=128); nothing but the streams and out touches device
// memory. Non-affine mode loads skip into the buffer that holds the raw x
// in affine mode, so it needs no more shared memory. The four weights (W_b,
// W_c: H*2P each, W2 and W1: H*H, 0.5 MB in f32 at the serving width) do
// not fit in shared memory beside the tile, so every product streams its
// weight from L2 (coalesced along the output column, each thread keeping
// kRT rows of accumulators; the A operand is a broadcast float4
// shared-memory read).
// The products are plain f32 FMA on the CUDA cores, no tensor cores: the
// layer is held to f32 accuracy.
//
// Bound: operations. Per row 2*H*2P (B-proj) + 2*2P*H (C-proj) + 2*H*H
// per GLU dense, about 0.27 MFLOP at H=192, P=128 with half1; at B=8,
// L=3751 that is 8.1 GFLOP, 0.12 ms at the card's 67 TFLOP/s f32 peak,
// against 46 MB of device memory traffic (x read, out written, weights),
// 0.014 ms at 3.35 TB/s; the non-affine mode reads one stream more (69 MB),
// a bf16 stream halves the stream bytes. Both stay bound by operations.
//
// Limits of this simple design: B CTAs in all (8 at B=8) fill B of the
// 132 SMs, so the kernel runs at most B/132 of the card's peak; within an
// SM it is bound by shared-memory reads and L2 weight streaming. Splitting
// a row's state channels over a thread-block cluster (reducing the
// C-projection through distributed shared memory) is the way to more SMs.

#include "layer_tail_body.cuh"

namespace {

using namespace tail;

__global__ void __launch_bounds__(kThreads)
layer_tail_kernel(const void* __restrict__ x, const void* __restrict__ skip,
                  void* __restrict__ out,
                  const float* __restrict__ nw, const float* __restrict__ nb,
                  const float* __restrict__ wb, const float* __restrict__ wc,
                  const float* __restrict__ dvec,
                  const float* __restrict__ lam_re,
                  const float* __restrict__ lam_im,
                  const float* __restrict__ o2k,
                  const float* __restrict__ o2b,
                  const float* __restrict__ o1k,
                  const float* __restrict__ o1b,
                  const float* __restrict__ m1, const float* __restrict__ m2,
                  int L, int H, int P, int glu, int act, int relu_state,
                  int layer_relu, int bf16) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldh = round4(H);
  const int ldp = round4(2 * P);
  float* X = smem;                 // the residual rows (x or skip)
  float* Z = X + kT * ldh;         // normed rows, later x1 = act(y)
  float* Y = Z + kT * ldh;         // y, later the "full" GLU base
  float* S = Y + kT * ldh;         // bu, then the states [re | im]
  float* carry = S + kT * ldp;     // (2P) carry [re | im] across tiles

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long row0 = (long long)b * L * H;
  if (m1) m1 += (long long)b * H;
  if (m2) m2 += (long long)b * H;

  for (int p = tid; p < 2 * P; p += blockDim.x) carry[p] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kT) {
    const int rows = min(kT, L - t0);
    // ---- load the tile (and apply the norm affine) ----
    load_tile(x, skip, row0, bf16, t0, rows, H, ldh, nw, nb, X, Z);
    __syncthreads();
    // ---- B-projection: S = Z @ W_b ----
    tile_matmul(Z, ldh, wb, H, 2 * P, rows,
                [&](int r, int c, float acc) { S[r * ldp + c] = acc; });
    __syncthreads();
    // ---- in-order scan over the tile, carry in shared memory ----
    scan_tile(S, ldp, P, rows, lam_re, lam_im, carry, relu_state != 0,
              nullptr);
    __syncthreads();
    // ---- C-projection + D * z: Y = S @ W_c + d * Z ----
    tile_matmul(S, ldp, wc, 2 * P, H, rows, [&](int r, int c, float acc) {
      Y[r * ldh + c] = fmaf(dvec[c], Z[r * ldh + c], acc);
    });
    __syncthreads();
    // ---- activation (x1 replaces z); no GLU: residual and store ----
    for (int i = tid; i < rows * H; i += blockDim.x) {
      const int r = i / H, c = i % H;
      const float x1 = x1_dropped(Y[r * ldh + c], act, m1, c);
      if (glu == kNone) {
        float o = x1 + X[r * ldh + c];
        if (layer_relu) o = fmaxf(o, 0.f);
        store_stream(out, row0 + (long long)(t0 + r) * H + c, o, bf16);
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
        const float gate = sigmoid_fn(acc + o2b[c]);
        float o = gated_out(base[r * ldh + c], gate, m2, c, X[r * ldh + c]);
        if (layer_relu) o = fmaxf(o, 0.f);
        store_stream(out, row0 + (long long)(t0 + r) * H + c, o, bf16);
      });
      __syncthreads();
    }
  }
}

}  // namespace

// x, out: (B, L, H) contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1),
// as is skip. Affine mode: skip null, x the raw input, nw, nb the norm
// affine. Non-affine mode: x the normed z, skip the residual, nw = nb =
// null. d, o2b, o1b, nw, nb: (H). wb: (H, 2P);
// wc: (2P, H), conj-sym factor folded in; o2k, o1k: (H, H) in (in, out)
// layout, null when the GLU variant does not use them. lam_re, lam_im: (P).
// m1, m2: (B, H) dropout masks or null.
// glu: 0 full, 1 half1, 2 half2, 3 none; act: 0 gelu, 1 relu. Returns
// cudaGetLastError() after the launch.
extern "C" int layer_tail_fwd(
    const void* x, const void* skip, void* out, const float* nw,
    const float* nb,
    const float* wb, const float* wc, const float* d, const float* lam_re,
    const float* lam_im, const float* o2k, const float* o2b,
    const float* o1k, const float* o1b, const float* m1, const float* m2,
    int B, int L, int H, int P, int glu, int act, int relu_state,
    int layer_relu, int bf16, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kT * (3 * round4(H) + round4(2 * P)) + 2 * P);
  cudaError_t err = cudaFuncSetAttribute(
      layer_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  layer_tail_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      x, skip, out, nw, nb, wb, wc, d, lam_re, lam_im, o2k, o2b, o1k, o1b, m1,
      m2, L, H, P, glu, act, relu_state, layer_relu, bf16);
  return (int)cudaGetLastError();
}
