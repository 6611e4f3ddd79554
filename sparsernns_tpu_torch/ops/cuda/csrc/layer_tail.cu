// K2: the whole S5 layer after the norm, forward (eval and training), as
// three passes over the whole card:
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
// non-affine modes, on f32 and bf16 streams. On the TPU the grid walks time
// blocks of a batch row in order with the carry in VMEM scratch. Only the
// recurrence couples time rows, so here it runs apart, and everything else
// in passes over all B*L rows:
//
//   tail_hist_bproj_kernel  S = z @ W_b, one CTA per (64 state columns,
//                           chunk of 128 rows of one batch row): K3a's own
//                           pass (layer_tail_body.cuh), 960 CTAs at B = 8.
//   tail_hist_scan_kernel   the states in place over S, a thread per (batch
//                           row, channel) over all of L: K3a's scan, with no
//                           history kept. S (B*L, 2P) f32 is scratch that
//                           the wrapper allocates (123 MB at B = 32).
//   layer_tail_row_kernel   a CTA owns 64 consecutive rows of the
//                           flattened B*L stream, which may straddle two
//                           batch rows (each row looks up its own m1, m2),
//                           and all H columns: y and x1 column tile by
//                           column tile (64 wide) from relu?(S) @ W_c, x1
//                           kept in shared memory; then per column tile the
//                           gate dense (with the full GLU's value dense, or
//                           half2's y again, in a second accumulator), the
//                           gating, the residual, the layer relu and the
//                           store. Without a GLU the first sweep stores.
//
// Every product is `gemm_tile` (layer_tail_body.cuh; here a 64x64 tile, 4x8
// outputs a thread in registers), each output one fmaf chain over k in
// ascending order from 0, and every elementwise step the device function
// of layer_tail_body.cuh in the same order. The states are the ones K3a
// computes, and K3b recomputes y, x1 and the gate with the same tile, so
// the backward's relu / layer-relu / gate decisions equal the forward's.
// The products are plain f32 FMA on the CUDA cores, no tensor cores: the
// layer is held to f32 accuracy. Each launch is recorded with its grid;
// layer_tail_fwd_launched hands the wrapper the record of the last call.
//
// Bound: operations. Per row 2*H*2P (B-proj) + 2*2P*H (C-proj) + 2*H*H
// per GLU dense, about 0.27 MFLOP at H=192, P=128 with half1; at B=8,
// L=3751 that is 8.1 GFLOP, 0.12 ms at the card's 67 TFLOP/s f32 peak,
// against 46 MB of stream and weight traffic (0.014 ms at 3.35 TB/s; the
// states add 31 MB written and read twice); the non-affine mode reads one
// stream more, a bf16 stream halves the stream bytes. All stay bound by
// operations. Shared memory of the row pass: 64 x ldx floats of x1 (51 KB
// at H = 192: three CTAs an SM, 12 warps, at most 168 registers a thread)
// beside the product's stages. A layer whose x1 tile does not fit in what
// the card lets a block opt in to (H above 872 on an H100) is refused
// before anything is launched.

#include "layer_tail_body.cuh"

namespace {

using namespace tail;

// A row of the x1 tile in shared memory: H rounded up to 8 mod 32 floats,
// so the four rows a warp's operand fetch reads fall in distinct banks.
__host__ __device__ inline int x1_ld(int H) { return (H + 23) / 32 * 32 + 8; }

struct TailArgs {
  const void* x;      // (B, L, H) stream: raw x (affine) or z
  const void* skip;   // (B, L, H) residual (non-affine) or null
  void* out;          // (B, L, H) stream
  const float* nw; const float* nb;          // (H) or null (non-affine)
  const float* wc; const float* d;           // (2P, H), (H)
  const float* o2k; const float* o2b;        // (H, H), (H) or null
  const float* o1k; const float* o1b;        // (H, H), (H) or null
  const float* m1; const float* m2;          // (B, H) or null
  const float* S;                            // (B*L, 2P) raw states
  long long n_rows;                          // B * L
  int L, H, P, glu, act, relu_state, layer_relu, bf16;
};

constexpr int kTail = 64;        // rows of the tail pass's product tile
constexpr int kTailR = kTail / 16;  // accumulator rows a thread
constexpr int kTooWide = -1;     // layer_tail_fwd: the x1 tile does not fit

// epi(m, c, i, j) for every output (m, c) of a thread's kTailR x 8
// accumulators (gemm_tile's layout) inside the first `rows` rows and
// `cols` columns.
template <class Epi>
__device__ __forceinline__ void tile_each(int rows, int cols, const Epi& epi) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < kTailR; ++i) {
    const int m = ty * kTailR + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = (j < 4 ? 0 : 32) + tx * 4 + (j & 3);
      if (m < rows && c < cols) epi(m, c, i, j);
    }
  }
}

__global__ void __launch_bounds__(kGT, 3)
layer_tail_row_kernel(const __grid_constant__ TailArgs a) {
  __shared__ __align__(16) GemmSmemT<kTail> sm;
  extern __shared__ float4 smem4[];
  float* X1 = reinterpret_cast<float*>(smem4);   // (kTail, ldx)
  const int H = a.H, N2 = 2 * a.P, ldx = x1_ld(H);
  const long long r0 = (long long)blockIdx.x * kTail;
  const int rows = (int)min((long long)kTail, a.n_rows - r0);
  const bool rs = a.relu_state != 0;
  const bool affine = a.nw != nullptr;
  auto states = [&](int m, int k) -> float {   // relu?(S), the C-proj's A
    if (m >= rows || k >= N2) return 0.f;
    const float v = a.S[(r0 + m) * N2 + k];
    return rs ? fmaxf(v, 0.f) : v;
  };
  auto x1_op = [&](int m, int k) -> float {    // x1, the GLU denses' A
    return m < rows && k < H ? X1[m * ldx + k] : 0.f;
  };
  // z and the residual at element el of column c, as K3a / K3b load them
  auto z_at = [&](long long el, int c) -> float {
    const float v = load_stream(a.x, el, a.bf16);
    return affine ? fmaf(v, a.nw[c], a.nb[c]) : v;
  };
  auto res_at = [&](long long el) -> float {
    return load_stream(affine ? a.x : a.skip, el, a.bf16);
  };
  // a mask's row for time row `row` (B*L < 2^31: 32-bit division)
  auto mask = [&](const float* mk, long long row) -> const float* {
    return mk ? mk + (long long)((int)row / a.L) * H : nullptr;
  };
  auto store = [&](long long el, float o) {
    if (a.layer_relu) o = fmaxf(o, 0.f);
    store_stream(a.out, el, o, a.bf16);
  };
  float acc[kTailR][8], acc2[kTailR][8];

  // ---- y = relu?(S) @ W_c + d*z, x1 = act(y) * m1 (no GLU: the store) ----
  for (int n0 = 0; n0 < H; n0 += kBN) {
    gemm_tile<true>(N2, states, [&](int k, int n) -> float {
      return k < N2 && n0 + n < H ? __ldg(a.wc + (long long)k * H + n0 + n)
                                  : 0.f;
    }, sm, acc);
    tile_each(rows, min(kBN, H - n0), [&](int m, int cl, int i, int j) {
      const int c = n0 + cl;
      const long long row = r0 + m;
      const long long el = row * H + c;
      const float y = fmaf(a.d[c], z_at(el, c), acc[i][j]);
      const float x1 = x1_dropped(y, a.act, mask(a.m1, row), c);
      if (a.glu == kNone) {
        store(el, x1 + res_at(el));
      } else {
        X1[m * ldx + c] = x1;
      }
    });
  }
  if (a.glu == kNone) return;
  __syncthreads();

  // ---- per column tile: the base, the gate, gating, residual, store ----
  for (int n0 = 0; n0 < H; n0 += kBN) {
    auto weight = [&](const float* w, int K) {
      return [=](int k, int n) -> float {
        return k < K && n0 + n < H ? __ldg(w + (long long)k * H + n0 + n)
                                   : 0.f;
      };
    };
    if (a.glu == kFull)          // the value dense x1 @ W1
      gemm_tile<true>(H, x1_op, weight(a.o1k, H), sm, acc2);
    else if (a.glu == kHalf2)    // y's product again, as the first sweep
      gemm_tile<true>(N2, states, weight(a.wc, N2), sm, acc2);
    gemm_tile<true>(H, x1_op, weight(a.o2k, H), sm, acc);
    tile_each(rows, min(kBN, H - n0), [&](int m, int cl, int i, int j) {
      const int c = n0 + cl;
      const long long row = r0 + m;
      const long long el = row * H + c;
      const float gate = sigmoid_fn(acc[i][j] + a.o2b[c]);
      float base;
      if (a.glu == kHalf1)
        base = X1[m * ldx + c];
      else if (a.glu == kHalf2)
        base = fmaf(a.d[c], z_at(el, c), acc2[i][j]);
      else
        base = acc2[i][j] + a.o1b[c];
      store(el, gated_out(base, gate, mask(a.m2, row), c, res_at(el)));
    });
  }
}

LaunchRecord g_launched;

}  // namespace

// x, out: (B, L, H) contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1),
// as is skip. Affine mode: skip null, x the raw input, nw, nb the norm
// affine. Non-affine mode: x the normed z, skip the residual, nw = nb =
// null. d, o2b, o1b, nw, nb: (H). wb: (H, 2P);
// wc: (2P, H), conj-sym factor folded in; o2k, o1k: (H, H) in (in, out)
// layout, null when the GLU variant does not use them. lam_re, lam_im: (P).
// m1, m2: (B, H) dropout masks or null. states: (B*L, 2P) f32 scratch.
// glu: 0 full, 1 half1, 2 half2, 3 none; act: 0 gelu, 1 relu. Returns
// kTooWide, launching nothing, where the row pass's x1 tile does not fit
// in the shared memory a block may opt in to on the current device; else
// the error of the first launch that fails, or 0.
extern "C" int layer_tail_fwd(
    const void* x, const void* skip, void* out, const float* nw,
    const float* nb,
    const float* wb, const float* wc, const float* d, const float* lam_re,
    const float* lam_im, const float* o2k, const float* o2b,
    const float* o1k, const float* o1b, const float* m1, const float* m2,
    float* states, int B, int L, int H, int P, int glu, int act,
    int relu_state, int layer_relu, int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  g_launched.n = 0;
  cudaError_t err;
  // ---- the x1 tile beside the product's staging, or refused ----
  const size_t smem =
      glu == kNone ? 0 : sizeof(float) * (size_t)kTail * x1_ld(H);
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (err = cudaFuncGetAttributes(&fa, layer_tail_row_kernel)) !=
          cudaSuccess)
    return (int)err;
  if (fa.sharedSizeBytes + smem > (size_t)optin) return kTooWide;
  // ---- S = z @ W_b, then the states in place ----
  const int cpr = (L + kBM - 1) / kBM;
  const dim3 grid_b((2 * P + kBN - 1) / kBN, B * cpr);
  tail_hist_bproj_kernel<<<grid_b, kGT, 0, st>>>(x, nw, nb, wb, states, L, H,
                                                 P, bf16, cpr);
  g_launched.add("tail_hist_bproj_kernel", grid_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid_s(B * ((P + kScanT - 1) / kScanT));
  tail_hist_scan_kernel<<<grid_s, kScanT, 0, st>>>(states, lam_re, lam_im,
                                                   nullptr, nullptr, L, P);
  g_launched.add("tail_hist_scan_kernel", grid_s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // ---- the tail over tiles of the flattened rows ----
  TailArgs a = {x, skip, out, nw, nb, wc, d, o2k, o2b, o1k, o1b, m1, m2,
                states, (long long)B * L, L, H, P, glu, act, relu_state,
                layer_relu, bf16};
  err = cudaFuncSetAttribute(layer_tail_row_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // three CTAs an SM where they fit: the carveout all shared memory
  err = cudaFuncSetAttribute(layer_tail_row_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_r((unsigned)((a.n_rows + kTail - 1) / kTail));
  layer_tail_row_kernel<<<grid_r, kGT, smem, st>>>(a);
  g_launched.add("layer_tail_row_kernel", grid_r);
  return (int)cudaGetLastError();
}

// The kernels that the last layer_tail_fwd launched, in order: up to `cap`
// of their names and grid sizes in CTAs. Returns how many it launched.
extern "C" int layer_tail_fwd_launched(const char** names, long long* ctas,
                                       int cap) {
  return g_launched.read(names, ctas, cap);
}
