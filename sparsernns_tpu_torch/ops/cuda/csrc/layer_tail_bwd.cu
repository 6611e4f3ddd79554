// Backward of the whole-layer tail (layer_tail.cu): K3a, the carry history
// with every state, and K3b, the adjoint, as passes that are parallel over
// time wherever the maths allows, so that one backward fills the card.
//
// They replace the TPU kernels of sparsernns_tpu/ops/pallas/
// fused_layer_bwd.py `fused_tail_bwd` (:364): the carry-history pre-pass
// (pallas_call at :489, body `_make_hist_kernel` :75) and the adjoint
// (pallas_call at :557, body `_make_bwd_kernel` :118), in the affine and the
// non-affine mode, on float32 and bfloat16 streams (x or z, skip, g read as
// the stream's type and widened to f32; g_x, g_skip rounded once at the
// store; every weight gradient f32, as the JAX kernels keep them). On the
// TPU both walk a sequential grid over the time blocks of a batch row, the
// carries in VMEM scratch. Here only the two linear recurrences walk time:
// the forward states and the adjoint v_t = g_t + conj(lam) v_{t+1}. Every
// product, activation and gradient of a time row depends on nothing but
// that row and those two recurrences, so it runs in a pass over all rows.
//
// Rows are the B*L time rows of the (B, L, .) arrays. A product pass cuts
// them into chunks of kBM rows of one batch row (the wrapper's plan,
// `bwd_plan` in layer_tail_bwd.py: B*ceil(L/kBM) chunks, 240 at B=8,
// L=3751) and the columns into kBN-wide tiles: one CTA per (column tile,
// chunk), 720 CTAs at B=8 for an H-wide product. The scratch arrays between
// the passes are (B*L, width) f32 in device memory: S (2P, the raw states),
// Y, X1D, F, G, GY (H), GS (2H), V (2P); 799 MB at B=32, L=3751 (half1).
//
// Every product is `gemm_tile`: a 128x64 CTA tile, 128 threads of 8x8
// outputs each in registers, both operands staged through shared memory in
// k-slices of 8, double-buffered (the next slice is fetched into registers
// while the current one is multiplied); three CTAs an SM (at most 168
// registers a thread), since more warps in flight hid more latency than
// unspilled registers or deeper slices gained on the card. The epilogue
// (`tile_epilogue`) puts the accumulator tile through shared memory, so
// its loads and stores run along rows, 32 consecutive elements a warp.
// Each output is one fmaf chain over k in ascending order from 0, and the
// products that recompute the forward (C-projection, the GLU denses) are
// the ones K2's tail pass computes (layer_tail.cu), over K2's own states
// (the B-projection and scan passes are one code, layer_tail_body.cuh), so
// they equal K2's bit for bit, and with them every relu, layer-relu and
// gate decision; the elementwise steps are the forward's device functions.
// The adjoint-only products use the same tile in f32 FMA too, each output
// one chain in ascending k (the full GLU's two products into g_x1d as two
// chains, summed). The tensor cores (a 3xTF32 tile) are later work.
//
// The weight gradients contract over time: each is a product of two
// (rows, .) arrays, split over `split_rows` slices of rows (about 48
// slices, the plan's), each CTA writing its slice's partial to its own
// slot of a (n_splits, M, N) buffer; vector gradients go per chunk into a
// (n_chunks, 7, H) buffer, d_lam per (batch row, channel). No atomics: the
// wrapper sums the partials in a fixed order, so two launches on the same
// inputs give the same bits. Each launch is recorded with its grid, and
// layer_tail_launched hands the wrapper the kernels and grids of the last
// K3a and K3b call, as they launched.
//
// The kernels, in launch order; bounds at H=192, P=128, half1, B=8,
// L=3751 (30,008 rows), the card's 67 TFLOP/s f32 and 3.35 TB/s:
//
// K3a (layer_tail_hist; replaces the pallas_call at fused_layer_bwd.py
// :489), bound 0.045 ms by operations (3.0 GFLOP); its two kernels are in
// layer_tail_body.cuh, which K2 launches too:
//   tail_hist_bproj_kernel  bu = z @ W_b into S, z = x*nw + nb or the z
//                           stream; one CTA per (column tile, chunk).
//   tail_hist_scan_kernel   x_t = lam x_{t-1} + bu_t in place over S, per
//                           (batch row, channel), the whole length in
//                           order with scan_step (scan_step.cuh), as K2;
//                           writes the state entering every 32-row tile
//                           (the history). One warp of channels a CTA;
//                           each thread keeps 32 steps of loads in flight,
//                           since the chain itself is short.
// K3b (layer_tail_bwd; replaces the pallas_call at :557), bound 0.32 ms
// by operations (21.7 GFLOP; the B-projection is K3a's):
//   tail_bwd_proj_kernel    y = relu?(S) @ W_c + d*z, x1d = act(y)*m1; no
//                           GLU: also the masked g and g_y.
//   tail_bwd_base_kernel    full GLU: the base x1d @ W1 + b1.
//   tail_bwd_gate_kernel    gate = sigmoid(x1d @ W2 + b2), the layer-relu
//                           mask, g_s and g_base into GS.
//   tail_bwd_gx1d_kernel    g_x1d = g_s @ W2^T (half1: + g_base; full:
//                           + g_base @ W1^T, a launch of its own first),
//                           g_y = g_x1d*m1*act'(y) (half2: + g_base).
//   tail_bwd_gxs_kernel     g_xs = g_y @ W_c^T, the relu_state mask, into V.
//   tail_bwd_wgrad_kernel   d_w_c = relu?(S)^T g_y, [d_o2k | d_o1k] =
//                           x1d^T [g_s | g_base]; after the adjoint scan
//                           d_w_b^T = v^T z.
//   tail_bwd_rev_kernel     v_t = g_xs,t + conj(lam) v_{t+1} in place over
//                           V per (batch row, channel), in the order and
//                           arithmetic of the TPU kernel's loop, and d_lam
//                           from the previous step's raw states.
//   tail_bwd_gz_kernel      g_zn = v @ W_b^T + g_y*d; affine: g_x = g_zn*nw
//                           + g, d_nw, d_nb; non-affine: g_z, g_skip.
// The product passes are bound by operations and fill every SM from B=8
// on (720-960 CTAs a pass); they run at 10-25 TFLOP/s of the f32 peak's
// 67. The two scans walk 3751 steps per (batch row, channel), 1024
// threads at B=8, and are bound by the latency of their loads, which the
// deep prefetch hides in part.

#include "layer_tail_body.cuh"

namespace {

using namespace tail;

constexpr int kNVec = 7;    // vector-gradient slots of a chunk
enum VecSlot { kDd = 0, kO2b, kO1b, kM1, kM2, kNw, kNb };

struct BwdArgs {
  // inputs
  const void* x; const void* g;              // (B, L, H) streams
  const void* skip;                          // (B, L, H) or null (affine)
  const float* nw; const float* nb;          // (H), null in non-affine mode
  const float* wb; const float* wc;          // (H, 2P), (2P, H)
  const float* wbT; const float* wcT;        // (2P, H), (H, 2P)
  const float* d;                            // (H)
  const float* lam_re; const float* lam_im;  // (P)
  const float* o2k; const float* o2b;        // (H, H), (H) or null
  const float* o1k; const float* o1b;        // (H, H), (H) or null (full)
  const float* gluT;                         // (n_glu*H, H): W2^T [; W1^T]
  const float* m1; const float* m2;          // (B, H) or null
  // scratch, (B*L, width) f32; S holds the raw states of K3a
  float* S; float* Y; float* X1D; float* F; float* G; float* GS; float* GY;
  float* V;
  // outputs
  void* gx;                                  // (B, L, H) stream
  void* gskip;                               // (B, L, H) or null (affine)
  float* vec;                                // (n_chunks, kNVec, H)
  float* dlam;                               // (2, B, P)
  float* dwc;                                // (n_splits, 2P, H)
  float* dglu;                               // (n_splits, H, n_glu*H)
  float* dwb;                                // (n_splits, 2P, H): d_w_b^T
  int B, L, H, P, glu, act, relu_state, layer_relu, bf16, cpr, split_rows;
};

// z at element `el` of column c: x*nw + nb (affine) or the z stream, as
// K2 computes it (layer_tail.cu)
__device__ inline float z_at(const BwdArgs& a, long long el, int c) {
  const float v = load_stream(a.x, el, a.bf16);
  return a.nw ? fmaf(v, a.nw[c], a.nb[c]) : v;
}

// the residual at element `el`: x (affine) or skip
__device__ inline float res_at(const BwdArgs& a, long long el) {
  return load_stream(a.nw ? a.x : a.skip, el, a.bf16);
}

// this CTA's columns of a vector-gradient slot of chunk ci
__device__ inline float* vec_slot(const BwdArgs& a, int ci, int slot,
                                  int n0) {
  return a.vec + ((long long)ci * kNVec + slot) * a.H + n0;
}

// ---------------------------------------------------------------- K3b

// y = relu?(S) @ W_c + d*z and x1d; without a GLU the adjoint of the
// element follows at once: the masked g, g_y, d_m1 and d_d
__global__ void __launch_bounds__(kGT, kMinCtas) tail_bwd_proj_kernel(const BwdArgs a) {
  __shared__ __align__(16) TileSmem sm;
  const int H = a.H, N2 = 2 * a.P;
  const Chunk ch = chunk_of(blockIdx.y, a.L, a.cpr);
  const int n0 = blockIdx.x * kBN;
  const bool rs = a.relu_state != 0;
  auto fa = [&](int m, int k) -> float {
    if (m >= ch.rows || k >= N2) return 0.f;
    const float v = a.S[(ch.row0 + m) * N2 + k];
    return rs ? fmaxf(v, 0.f) : v;
  };
  auto fb = [&](int k, int n) -> float {
    return k < N2 && n0 + n < H ? __ldg(a.wc + (long long)k * H + n0 + n)
                                : 0.f;
  };
  float acc[8][8];
  gemm_tile<true>(N2, fa, fb, sm.g, acc);
  const int cols = min(kBN, H - n0);
  const float* m1 = a.m1 ? a.m1 + (long long)ch.b * H : nullptr;
  const bool gated = a.glu != kNone;
  float s_m1 = 0.f, s_dd = 0.f;
  tile_epilogue(acc, sm, ch.rows, cols, [&](int m, int cl, float v) {
    const int c = n0 + cl;
    const long long el = (ch.row0 + m) * H + c;
    const float z = z_at(a, el, c);
    const float y = fmaf(a.d[c], z, v);
    const float x1d = x1_dropped(y, a.act, m1, c);
    if (gated) {
      a.Y[el] = y;
      a.X1D[el] = x1d;
      return;
    }
    float gv = load_stream(a.g, el, a.bf16);
    if (a.layer_relu && !(x1d + res_at(a, el) > 0.f)) gv = 0.f;
    a.G[el] = gv;
    s_m1 += gv * act_fn(y, a.act);
    const float g_y = (gv * (m1 ? m1[c] : 1.f)) * act_grad(y, a.act);
    a.GY[el] = g_y;
    s_dd += g_y * z;
  });
  if (gated) return;
  if (m1) tile_col_sum(s_m1, sm, vec_slot(a, blockIdx.y, kM1, n0), cols);
  tile_col_sum(s_dd, sm, vec_slot(a, blockIdx.y, kDd, n0), cols);
}

// the full GLU's base: F = x1d @ W1 + b1
__global__ void __launch_bounds__(kGT, kMinCtas) tail_bwd_base_kernel(const BwdArgs a) {
  __shared__ __align__(16) TileSmem sm;
  const int H = a.H;
  const Chunk ch = chunk_of(blockIdx.y, a.L, a.cpr);
  const int n0 = blockIdx.x * kBN;
  auto fa = [&](int m, int k) -> float {
    return m < ch.rows && k < H ? a.X1D[(ch.row0 + m) * H + k] : 0.f;
  };
  auto fb = [&](int k, int n) -> float {
    return k < H && n0 + n < H ? __ldg(a.o1k + (long long)k * H + n0 + n)
                               : 0.f;
  };
  float acc[8][8];
  gemm_tile<true>(H, fa, fb, sm.g, acc);
  tile_epilogue(acc, sm, ch.rows, min(kBN, H - n0),
                [&](int m, int cl, float v) {
                  const int c = n0 + cl;
                  a.F[(ch.row0 + m) * H + c] = v + a.o1b[c];
                });
}

// gate = sigmoid(x1d @ W2 + b2), the layer-relu mask on g, g_s and g_base
// into GS = [g_s | g_base]; d_m2, d_o2b, d_o1b
__global__ void __launch_bounds__(kGT, kMinCtas) tail_bwd_gate_kernel(const BwdArgs a) {
  __shared__ __align__(16) TileSmem sm;
  const int H = a.H, glu = a.glu;
  const Chunk ch = chunk_of(blockIdx.y, a.L, a.cpr);
  const int n0 = blockIdx.x * kBN;
  auto fa = [&](int m, int k) -> float {
    return m < ch.rows && k < H ? a.X1D[(ch.row0 + m) * H + k] : 0.f;
  };
  auto fb = [&](int k, int n) -> float {
    return k < H && n0 + n < H ? __ldg(a.o2k + (long long)k * H + n0 + n)
                               : 0.f;
  };
  float acc[8][8];
  gemm_tile<true>(H, fa, fb, sm.g, acc);
  const int cols = min(kBN, H - n0);
  const float* m2 = a.m2 ? a.m2 + (long long)ch.b * H : nullptr;
  const float* base_buf = glu == kHalf1 ? a.X1D : (glu == kHalf2 ? a.Y : a.F);
  float s_m2 = 0.f, s_o2b = 0.f, s_o1b = 0.f;
  tile_epilogue(acc, sm, ch.rows, cols, [&](int m, int cl, float v) {
    const int c = n0 + cl;
    const long long row = ch.row0 + m;
    const long long el = row * H + c;
    const float gate = sigmoid_fn(v + a.o2b[c]);
    const float base = base_buf[el];
    float gv = load_stream(a.g, el, a.bf16);
    if (a.layer_relu && !(gated_out(base, gate, m2, c, res_at(a, el)) > 0.f))
      gv = 0.f;
    s_m2 += gv * (base * gate);
    const float g_h = gv * (m2 ? m2[c] : 1.f);
    const float g_base = g_h * gate;
    const float g_s = (g_h * base) * gate * (1.f - gate);
    a.GS[row * 2 * H + c] = g_s;
    a.GS[row * 2 * H + H + c] = g_base;
    a.G[el] = gv;
    s_o2b += g_s;
    s_o1b += g_base;
  });
  if (m2) tile_col_sum(s_m2, sm, vec_slot(a, blockIdx.y, kM2, n0), cols);
  tile_col_sum(s_o2b, sm, vec_slot(a, blockIdx.y, kO2b, n0), cols);
  if (glu == kFull)
    tile_col_sum(s_o1b, sm, vec_slot(a, blockIdx.y, kO1b, n0), cols);
}

// g_x1d = g_s @ W2^T, plus g_base (half1) or g_base @ W1^T (full: kBase
// runs that product first into GY, and the sum is of the two chains);
// then g_y = g_x1d*m1*act'(y)
// (half2: + g_base); d_m1, d_d
template <bool kBase>
__global__ void __launch_bounds__(kGT, kMinCtas) tail_bwd_gx1d_kernel(const BwdArgs a) {
  __shared__ __align__(16) TileSmem sm;
  const int H = a.H, glu = a.glu;
  const Chunk ch = chunk_of(blockIdx.y, a.L, a.cpr);
  const int n0 = blockIdx.x * kBN;
  const int k0 = kBase ? H : 0;   // g_base and W1^T, or g_s and W2^T
  auto fa = [&](int m, int k) -> float {
    return m < ch.rows && k < H ? a.GS[(ch.row0 + m) * 2 * H + k0 + k] : 0.f;
  };
  auto fb = [&](int k, int n) -> float {
    return k < H && n0 + n < H
               ? __ldg(a.gluT + (long long)(k0 + k) * H + n0 + n)
               : 0.f;
  };
  float acc[8][8];
  gemm_tile<true>(H, fa, fb, sm.g, acc);
  const int cols = min(kBN, H - n0);
  if (kBase) {
    tile_epilogue(acc, sm, ch.rows, cols, [&](int m, int cl, float v) {
      a.GY[(ch.row0 + m) * H + n0 + cl] = v;
    });
    return;
  }
  const float* m1 = a.m1 ? a.m1 + (long long)ch.b * H : nullptr;
  float s_m1 = 0.f, s_dd = 0.f;
  tile_epilogue(acc, sm, ch.rows, cols, [&](int m, int cl, float v) {
    const int c = n0 + cl;
    const long long row = ch.row0 + m;
    const long long el = row * H + c;
    const float g_base = a.GS[row * 2 * H + H + c];
    const float g1 = glu == kHalf1   ? v + g_base
                     : glu == kFull ? v + a.GY[el]
                                    : v;
    const float y = a.Y[el];
    s_m1 += g1 * act_fn(y, a.act);
    float g_y = (g1 * (m1 ? m1[c] : 1.f)) * act_grad(y, a.act);
    if (glu == kHalf2) g_y += g_base;
    a.GY[el] = g_y;
    s_dd += g_y * z_at(a, el, c);
  });
  if (m1) tile_col_sum(s_m1, sm, vec_slot(a, blockIdx.y, kM1, n0), cols);
  tile_col_sum(s_dd, sm, vec_slot(a, blockIdx.y, kDd, n0), cols);
}

// g_xs = g_y @ W_c^T into V, zero where relu_state cut the raw state
__global__ void __launch_bounds__(kGT, kMinCtas) tail_bwd_gxs_kernel(const BwdArgs a) {
  __shared__ __align__(16) TileSmem sm;
  const int H = a.H, N2 = 2 * a.P;
  const Chunk ch = chunk_of(blockIdx.y, a.L, a.cpr);
  const int n0 = blockIdx.x * kBN;
  auto fa = [&](int m, int k) -> float {
    return m < ch.rows && k < H ? a.GY[(ch.row0 + m) * H + k] : 0.f;
  };
  auto fb = [&](int k, int n) -> float {
    return k < H && n0 + n < N2 ? __ldg(a.wcT + (long long)k * N2 + n0 + n)
                                : 0.f;
  };
  float acc[8][8];
  gemm_tile<true>(H, fa, fb, sm.g, acc);
  tile_epilogue(acc, sm, ch.rows, min(kBN, N2 - n0),
                [&](int m, int cl, float v) {
                  const long long at = (ch.row0 + m) * N2 + n0 + cl;
                  a.V[at] = a.relu_state && !(a.S[at] > 0.f) ? 0.f : v;
                });
}

// A weight gradient's partial over one slice of rows: part[s](m, n) = sum
// over rows r of the slice of A(r, m) * Bm(r, n). kWhich 0: d_w_c =
// relu?(S)^T g_y (2P x H); 1: x1d^T [g_s | g_base] (H x n_glu*H); 2:
// d_w_b^T = v^T z (2P x H: M a multiple of the tile's 128 rows, so no
// tile is half empty; the wrapper transposes the sum).
template <int kWhich>
__global__ void __launch_bounds__(kGT, kMinCtas) tail_bwd_wgrad_kernel(const BwdArgs a) {
  __shared__ __align__(16) TileSmem sm;
  const int H = a.H, N2 = 2 * a.P;
  const int n_glu = a.glu == kFull ? 2 : 1;
  const int M = kWhich == 1 ? H : N2;
  const int N = kWhich == 1 ? n_glu * H : H;
  const long long rows = (long long)a.B * a.L;
  const long long r0 = (long long)blockIdx.z * a.split_rows;
  const int n_rows = (int)min((long long)a.split_rows, rows - r0);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bool rs = a.relu_state != 0;
  auto fa = [&](int m, int k) -> float {
    const int f = m0 + m;
    if (k >= n_rows || f >= M) return 0.f;
    const long long r = r0 + k;
    if (kWhich == 0) {
      const float v = a.S[r * N2 + f];
      return rs ? fmaxf(v, 0.f) : v;
    }
    if (kWhich == 1) return a.X1D[r * H + f];
    return a.V[r * N2 + f];
  };
  // z's affine at this thread's column of every B fetch (tid % kBN)
  const int fz = n0 + (int)threadIdx.x % kBN;
  const bool zin = kWhich == 2 && a.nw && fz < H;
  const float zw = zin ? a.nw[fz] : 1.f, zb = zin ? a.nb[fz] : 0.f;
  auto fb = [&](int k, int n) -> float {
    const int f = n0 + n;
    if (k >= n_rows || f >= N) return 0.f;
    const long long r = r0 + k;
    if (kWhich == 0) return a.GY[r * H + f];
    if (kWhich == 1) return a.GS[r * 2 * H + f];
    const float v = load_stream(a.x, r * H + f, a.bf16);
    return a.nw ? fmaf(v, zw, zb) : v;
  };
  float acc[8][8];
  gemm_tile<false>(n_rows, fa, fb, sm.g, acc);
  float* part = (kWhich == 0 ? a.dwc : (kWhich == 1 ? a.dglu : a.dwb)) +
                (long long)blockIdx.z * M * N;
  tile_epilogue(acc, sm, min(kBM, M - m0), min(kBN, N - n0),
                [&](int m, int c, float v) {
                  part[(long long)(m0 + m) * N + n0 + c] = v;
                });
}

// v_t = g_xs,t + conj(lam) v_{t+1} over the whole row, last step first, in
// place over V; d_lam from the previous step's raw states (step 0: the
// zero initial state)
__global__ void __launch_bounds__(kScanT) tail_bwd_rev_kernel(const BwdArgs a) {
  constexpr int kU = 16;
  const int P = a.P, L = a.L;
  const int groups = (P + kScanT - 1) / kScanT;
  const int b = blockIdx.x / groups;
  const int p = (blockIdx.x % groups) * kScanT + threadIdx.x;
  if (p >= P) return;
  float* v = a.V + (long long)b * L * 2 * P;
  const float* s = a.S + (long long)b * L * 2 * P;
  const float lr = a.lam_re[p], li = a.lam_im[p];
  float vr = 0.f, vi = 0.f, s_lr = 0.f, s_li = 0.f;
  float gr[kU], gi[kU], xr[kU], xi[kU], ngr[kU], ngi[kU], nxr[kU], nxi[kU];
  auto fetch = [&](int t_hi, float (&r)[kU], float (&i)[kU], float (&pr)[kU],
                   float (&pi)[kU]) {
    fetch_steps<kU>(v, P, L, p, t_hi, -1, r, i);
    fetch_steps<kU>(s, P, L, p, t_hi - 1, -1, pr, pi);  // step t's previous
  };
  fetch(L - 1, gr, gi, xr, xi);
  for (int t_hi = L - 1; t_hi >= 0; t_hi -= kU) {
    if (t_hi - kU >= 0) fetch(t_hi - kU, ngr, ngi, nxr, nxi);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t_hi - u;
      if (t >= 0) {
        const float nr = gr[u] + (lr * vr + li * vi);
        const float ni = gi[u] + (lr * vi - li * vr);
        vr = nr;
        vi = ni;
        v[(long long)t * 2 * P + p] = vr;
        v[(long long)t * 2 * P + P + p] = vi;
        s_lr += vr * xr[u] + vi * xi[u];
        s_li += vi * xr[u] - vr * xi[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      gr[u] = ngr[u];
      gi[u] = ngi[u];
      xr[u] = nxr[u];
      xi[u] = nxi[u];
    }
  }
  a.dlam[(long long)b * P + p] = s_lr;
  a.dlam[(long long)(a.B + b) * P + p] = s_li;
}

// g_zn = v @ W_b^T + g_y*d; affine: g_x = g_zn*nw + g, d_nw, d_nb;
// non-affine: g_z = g_zn and g_skip = the masked g
__global__ void __launch_bounds__(kGT, kMinCtas) tail_bwd_gz_kernel(const BwdArgs a) {
  __shared__ __align__(16) TileSmem sm;
  const int H = a.H, N2 = 2 * a.P;
  const Chunk ch = chunk_of(blockIdx.y, a.L, a.cpr);
  const int n0 = blockIdx.x * kBN;
  const bool affine = a.nw != nullptr;
  auto fa = [&](int m, int k) -> float {
    return m < ch.rows && k < N2 ? a.V[(ch.row0 + m) * N2 + k] : 0.f;
  };
  auto fb = [&](int k, int n) -> float {
    return k < N2 && n0 + n < H ? __ldg(a.wbT + (long long)k * H + n0 + n)
                                : 0.f;
  };
  float acc[8][8];
  gemm_tile<true>(N2, fa, fb, sm.g, acc);
  const int cols = min(kBN, H - n0);
  float s_nw = 0.f, s_nb = 0.f;
  tile_epilogue(acc, sm, ch.rows, cols, [&](int m, int cl, float v) {
    const int c = n0 + cl;
    const long long el = (ch.row0 + m) * H + c;
    const float g_zn = fmaf(a.GY[el], a.d[c], v);
    const float gv = a.G[el];
    if (affine) {
      s_nw += g_zn * load_stream(a.x, el, a.bf16);
      s_nb += g_zn;
      store_stream(a.gx, el, fmaf(g_zn, a.nw[c], gv), a.bf16);
    } else {
      store_stream(a.gx, el, g_zn, a.bf16);
      store_stream(a.gskip, el, gv, a.bf16);
    }
  });
  if (!affine) return;
  tile_col_sum(s_nw, sm, vec_slot(a, blockIdx.y, kNw, n0), cols);
  tile_col_sum(s_nb, sm, vec_slot(a, blockIdx.y, kNb, n0), cols);
}

int scan_ctas(int B, int P) { return B * ((P + kScanT - 1) / kScanT); }

// The kernels that the last call of layer_tail_hist (entry 0) and of
// layer_tail_bwd (entry 1) launched: the record that layer_tail_launched
// hands the wrapper.
LaunchRecord g_launched[2];

}  // namespace

// Launch `kernel` on `grid` x `threads` with the parenthesised `args` on
// stream st, record it for layer_tail_launched, and return the error of a
// launch that fails.
#define LAUNCH(call, kernel, grid, threads, args)          \
  kernel<<<grid, threads, 0, st>>> args;                   \
  g_launched[call].add(#kernel, grid);                     \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err

// K3a: every state and the entry state of every 32-row time tile. x: (B, L,
// H), float32 (bf16 = 0) or bfloat16 (bf16 = 1): the raw input with nw, nb,
// or the normed z with nw = nb = null; states: (B, L, 2P) f32 [re | im];
// hist_re, hist_im: (B, ceil(L / 32), P). Returns cudaGetLastError() after
// the launches.
extern "C" int layer_tail_hist(const void* x, const float* nw,
                               const float* nb, const float* wb,
                               const float* lam_re, const float* lam_im,
                               float* states, float* hist_re, float* hist_im,
                               int B, int L, int H, int P, int bf16,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int cpr = (L + kBM - 1) / kBM;
  const dim3 grid((2 * P + kBN - 1) / kBN, B * cpr);
  const dim3 grid_scan(scan_ctas(B, P));
  cudaError_t err;
  g_launched[0].n = 0;
  LAUNCH(0, tail_hist_bproj_kernel, grid, kGT,
         (x, nw, nb, wb, states, L, H, P, bf16, cpr));
  LAUNCH(0, tail_hist_scan_kernel, grid_scan, kScanT,
         (states, lam_re, lam_im, hist_re, hist_im, L, P));
  return 0;
}

// The time rows of a history tile, so that the wrapper sizes the history.
extern "C" int layer_tail_tile_rows() { return kT; }

// The time rows of a product pass's chunk, the wrapper's plan unit.
extern "C" int layer_tail_chunk_rows() { return kBM; }

// The kernels that the last layer_tail_hist (call = 0) or layer_tail_bwd
// (call = 1) launched, in order: up to `cap` of their names and grid sizes
// in CTAs into `names` and `ctas`. Returns how many it launched.
extern "C" int layer_tail_launched(int call, const char** names,
                                   long long* ctas, int cap) {
  return g_launched[call].read(names, ctas, cap);
}

// K3b. `ptrs` holds the pointers of BwdArgs in declaration order up to the
// scratch and outputs (null where the mode, a GLU variant or a missing
// mask leaves one out); S must hold K3a's states. The streams x, g, skip,
// gx, gskip are float32 (bf16 = 0) or bfloat16 (bf16 = 1). Returns
// cudaGetLastError() after the first launch that fails, or 0.
extern "C" int layer_tail_bwd(const void* const* ptrs, int B, int L, int H,
                              int P, int glu, int act, int relu_state,
                              int layer_relu, int bf16, int split_rows,
                              void* stream) {
  BwdArgs a;
  int i = 0;
  auto in = [&]() { return static_cast<const float*>(ptrs[i++]); };
  auto out = [&]() {
    return const_cast<float*>(static_cast<const float*>(ptrs[i++]));
  };
  a.x = ptrs[i++]; a.g = ptrs[i++]; a.skip = ptrs[i++];
  a.nw = in(); a.nb = in(); a.wb = in(); a.wc = in();
  a.wbT = in(); a.wcT = in(); a.d = in(); a.lam_re = in(); a.lam_im = in();
  a.o2k = in(); a.o2b = in(); a.o1k = in(); a.o1b = in(); a.gluT = in();
  a.m1 = in(); a.m2 = in();
  a.S = out(); a.Y = out(); a.X1D = out(); a.F = out(); a.G = out();
  a.GS = out(); a.GY = out(); a.V = out();
  a.gx = const_cast<void*>(ptrs[i++]);
  a.gskip = const_cast<void*>(ptrs[i++]);
  a.vec = out(); a.dlam = out(); a.dwc = out(); a.dglu = out();
  a.dwb = out();
  a.B = B; a.L = L; a.H = H; a.P = P; a.glu = glu; a.act = act;
  a.relu_state = relu_state; a.layer_relu = layer_relu; a.bf16 = bf16;
  a.cpr = (L + kBM - 1) / kBM;
  a.split_rows = split_rows;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = B * a.cpr;
  const int n_splits = (int)(((long long)B * L + split_rows - 1) / split_rows);
  const int n_glu = glu == kFull ? 2 : 1;
  const dim3 grid_h((H + kBN - 1) / kBN, n_chunks);
  const dim3 grid_p((2 * P + kBN - 1) / kBN, n_chunks);
  // the weight-gradient products: (column tiles, row tiles, slices)
  const dim3 grid_wp((H + kBN - 1) / kBN, (2 * P + kBM - 1) / kBM, n_splits);
  const dim3 grid_wglu((n_glu * H + kBN - 1) / kBN, (H + kBM - 1) / kBM,
                       n_splits);
  const dim3 grid_scan(scan_ctas(B, P));
  cudaError_t err;
  g_launched[1].n = 0;
  LAUNCH(1, tail_bwd_proj_kernel, grid_h, kGT, (a));
  if (glu == kFull) {
    LAUNCH(1, tail_bwd_base_kernel, grid_h, kGT, (a));
  }
  if (glu != kNone) {
    LAUNCH(1, tail_bwd_gate_kernel, grid_h, kGT, (a));
    if (glu == kFull) {
      LAUNCH(1, tail_bwd_gx1d_kernel<true>, grid_h, kGT, (a));
    }
    LAUNCH(1, tail_bwd_gx1d_kernel<false>, grid_h, kGT, (a));
  }
  LAUNCH(1, tail_bwd_gxs_kernel, grid_p, kGT, (a));
  LAUNCH(1, tail_bwd_wgrad_kernel<0>, grid_wp, kGT, (a));
  if (glu != kNone) {
    LAUNCH(1, tail_bwd_wgrad_kernel<1>, grid_wglu, kGT, (a));
  }
  LAUNCH(1, tail_bwd_rev_kernel, grid_scan, kScanT, (a));
  LAUNCH(1, tail_bwd_gz_kernel, grid_h, kGT, (a));
  LAUNCH(1, tail_bwd_wgrad_kernel<2>, grid_wp, kGT, (a));
  return 0;
}
#undef LAUNCH
