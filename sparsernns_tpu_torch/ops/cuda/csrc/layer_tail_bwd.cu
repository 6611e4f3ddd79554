// Backward of the whole-layer tail (layer_tail.cu), two kernels, one CTA per
// batch row each:
//
//   layer_tail_hist  walks the row forward (z = x * nw + nb, or the z stream
//                    itself in non-affine mode; bu = z @ W_b, scan) and
//                    writes only the state that enters every time tile:
//                    (B, n_tiles, P) re and im, tile 0 zero;
//   layer_tail_bwd   walks the tiles last to first. Per tile it recomputes the
//                    forward chain from the tile's entry state, runs the
//                    adjoint chain top down, the reverse-time recurrence
//                    v_t = g_t + conj(lam) * v_{t+1} with its carry kept
//                    across tiles, and writes g_x (non-affine mode: g_z and
//                    g_skip); every weight gradient is accumulated per
//                    batch row.
//
// They replace the TPU kernels of sparsernns_tpu/ops/pallas/
// fused_layer_bwd.py `fused_tail_bwd` (:364): the carry-history pre-pass
// (pallas_call at :489, body `_make_hist_kernel` :75) and the adjoint
// (pallas_call at :557, body `_make_bwd_kernel` :118), in the affine and the
// non-affine mode, on float32 and bfloat16 streams (x or z, skip, g read as
// the stream's type and widened to f32; g_x, g_skip rounded once at the
// store; every weight gradient f32, as the JAX kernels keep them). On the
// TPU both walk a sequential grid with the carry in VMEM scratch and the
// gradients resident in VMEM; here a CTA loops over its row's tiles itself,
// the adjoint carry lives in shared memory, and the checkpoint block is the
// 32-row tile, so the entry state of a tile is one row of the history.
//
// The recomputed chain uses the forward's device functions
// (layer_tail_body.cuh), so every relu, layer-relu and gate decision equals
// the forward's. Products with a transposed weight (g_s @ W2^T, g_base @
// W1^T, g_y @ W_c^T, v @ W_b^T) read transposed copies that the wrapper
// makes once per call and go through the same tile_matmul. The
// time-contracted weight gradients (z^T v, xs^T g_y, x1^T g_s, x1^T g_base)
// are H*2P, 2P*H and H*H floats per batch row, more than shared memory holds
// beside the tile, so each CTA accumulates them into its own row of a
// (B, ...) device buffer: the first tile it processes stores, later tiles
// add, no atomics, a fixed order; the wrapper sums over B. Vector gradients
// (d, biases, masks, nw, nb, lam) accumulate in shared memory and are
// written once.
//
// Shared memory of the adjoint: six (32, H) buffers, two (32, 2P) buffers,
// the scan carries and the vector accumulators: 222,464 bytes at H=192,
// P=128, under the 227 KB a block can have. The residual tile (x, or skip in
// non-affine mode) is not kept to the end (its buffer takes the masked g,
// which is g_skip in non-affine mode); the last pass of the affine mode
// reads x again for d_nw. A seventh (32, H) buffer would not fit, so the
// non-affine mode reuses the same six.
//
// Bound: operations. The adjoint does the forward's four products again,
// four transposed products and four weight-gradient products, about three
// times the forward's count: 0.81 MFLOP a row at H=192, P=128, half1; at
// B=8, L=3751 24 GFLOP, 0.36 ms at the card's 67 TFLOP/s f32 peak, against
// 73 MB of device memory traffic (x, g read, g_x written, per-row weight
// gradients written), 0.022 ms at 3.35 TB/s. The history pass does the
// B-projection and the scan: 3.0 GFLOP, 0.045 ms. Like the forward, B CTAs
// fill B of the 132 SMs and the products are plain f32 FMA.

#include "layer_tail_body.cuh"

namespace {

using namespace tail;

constexpr int kMT = 8;  // weight-gradient rows per thread

__global__ void __launch_bounds__(kThreads)
layer_tail_hist_kernel(const void* __restrict__ x,
                       const float* __restrict__ nw,
                       const float* __restrict__ nb,
                       const float* __restrict__ wb,
                       const float* __restrict__ lam_re,
                       const float* __restrict__ lam_im,
                       float* __restrict__ hist_re,
                       float* __restrict__ hist_im, int L, int H, int P,
                       int bf16) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldh = round4(H);
  const int ldp = round4(2 * P);
  float* Z = smem;
  float* S = Z + kT * ldh;
  float* carry = S + kT * ldp;

  const int b = blockIdx.x;
  const int n_tiles = (L + kT - 1) / kT;
  const long long row0 = (long long)b * L * H;
  float* hr = hist_re + (long long)b * n_tiles * P;
  float* hi = hist_im + (long long)b * n_tiles * P;

  for (int p = threadIdx.x; p < 2 * P; p += blockDim.x) carry[p] = 0.f;
  __syncthreads();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kT;
    const int rows = min(kT, L - t0);
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      hr[(long long)tile * P + p] = carry[p];
      hi[(long long)tile * P + p] = carry[P + p];
    }
    if (tile == n_tiles - 1) break;   // its exit state is not needed
    load_tile(x, nullptr, row0, bf16, t0, rows, H, ldh, nw, nb, nullptr, Z);
    __syncthreads();
    tile_matmul(Z, ldh, wb, H, 2 * P, rows,
                [&](int r, int c, float acc) { S[r * ldp + c] = acc; });
    __syncthreads();
    scan_tile(S, ldp, P, rows, lam_re, lam_im, carry, false, nullptr);
    __syncthreads();
  }
}

// dW(m, n) (+)= sum_r A[r*lda + m] * Bm[r*ldb + n] over the tile's rows; A
// and Bm in shared memory, dW (M, N) row-major in this batch row's slice of
// device memory. `relu_a` applies the mixer relu to A on load. The first
// tile stores, later tiles add.
__device__ inline void tile_outer_accum(const float* A, int lda,
                                        const float* Bm, int ldb,
                                        float* __restrict__ dW, int M, int N,
                                        int rows, bool relu_a, bool first) {
  const int m_groups = (M + kMT - 1) / kMT;
  const int n_items = m_groups * N;
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const int n = item % N;
    const int m0 = (item / N) * kMT;
    float acc[kMT];
#pragma unroll
    for (int i = 0; i < kMT; ++i) acc[i] = 0.f;
    if (m0 + kMT <= M) {
      for (int r = 0; r < rows; ++r) {
        const float bv = Bm[r * ldb + n];
        float4 a0 = *reinterpret_cast<const float4*>(A + r * lda + m0);
        float4 a1 = *reinterpret_cast<const float4*>(A + r * lda + m0 + 4);
        if (relu_a) {
          a0.x = fmaxf(a0.x, 0.f); a0.y = fmaxf(a0.y, 0.f);
          a0.z = fmaxf(a0.z, 0.f); a0.w = fmaxf(a0.w, 0.f);
          a1.x = fmaxf(a1.x, 0.f); a1.y = fmaxf(a1.y, 0.f);
          a1.z = fmaxf(a1.z, 0.f); a1.w = fmaxf(a1.w, 0.f);
        }
        acc[0] = fmaf(a0.x, bv, acc[0]);
        acc[1] = fmaf(a0.y, bv, acc[1]);
        acc[2] = fmaf(a0.z, bv, acc[2]);
        acc[3] = fmaf(a0.w, bv, acc[3]);
        acc[4] = fmaf(a1.x, bv, acc[4]);
        acc[5] = fmaf(a1.y, bv, acc[5]);
        acc[6] = fmaf(a1.z, bv, acc[6]);
        acc[7] = fmaf(a1.w, bv, acc[7]);
      }
    } else {
      for (int r = 0; r < rows; ++r) {
        const float bv = Bm[r * ldb + n];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          if (m0 + i < M) {
            float a = A[r * lda + m0 + i];
            if (relu_a) a = fmaxf(a, 0.f);
            acc[i] = fmaf(a, bv, acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (m0 + i < M) {
        float* o = dW + (long long)(m0 + i) * N + n;
        *o = first ? acc[i] : *o + acc[i];
      }
    }
  }
}

struct BwdArgs {
  // inputs
  const void* x; const void* g;              // (B, L, H) streams
  const void* skip;                          // (B, L, H) or null (affine)
  const float* nw; const float* nb;          // (H), null in non-affine mode
  const float* wb; const float* wc;          // (H, 2P), (2P, H)
  const float* wbT; const float* wcT;        // (2P, H), (H, 2P)
  const float* d;                            // (H)
  const float* lam_re; const float* lam_im;  // (P)
  const float* o2k; const float* o2kT; const float* o2b;
  const float* o1k; const float* o1kT; const float* o1b;
  const float* m1; const float* m2;          // (B, H) or null
  const float* hist_re; const float* hist_im;  // (B, n_tiles, P)
  // outputs; every gradient but gx is per batch row
  void* gx;                                  // (B, L, H) stream
  void* gskip;                               // (B, L, H) or null (affine)
  float* dwb; float* dwc;                    // (B, H, 2P), (B, 2P, H)
  float* do2k; float* do1k;                  // (B, H, H) or null
  float* dd; float* do2b; float* do1b;       // (B, H)
  float* dm1; float* dm2;                    // (B, H) or null
  float* dnw; float* dnb;                    // (B, H) or null
  float* dlam_re; float* dlam_im;            // (B, P)
  int L, H, P, glu, act, relu_state, layer_relu, bf16;
};

__global__ void __launch_bounds__(kThreads)
layer_tail_bwd_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int L = a.L, H = a.H, P = a.P, glu = a.glu, act = a.act;
  const int ldh = round4(H);
  const int ldp = round4(2 * P);
  float* XG = smem;               // residual rows, then the masked g
  float* Z = XG + kT * ldh;       // normed rows
  float* Y = Z + kT * ldh;        // y
  float* D = Y + kT * ldh;        // x1 after m1; g_x1d; g_zn
  float* E = D + kT * ldh;        // gate; g_s; g_y
  float* F = E + kT * ldh;        // "full" base; g_base
  float* S = F + kT * ldh;        // bu, then the raw states [re | im]
  float* V = S + kT * ldp;        // relu'd states; g_xs; v
  float* entry = V + kT * ldp;    // (2P) state entering the tile
  float* fcarry = entry + 2 * P;  // (2P) the recomputed scan's moving carry
  float* vcarry = fcarry + 2 * P; // (2P) adjoint carry across tiles
  float* acc_dd = vcarry + 2 * P;   // (H) each, then (P) each
  float* acc_o2b = acc_dd + H;
  float* acc_o1b = acc_o2b + H;
  float* acc_m1 = acc_o1b + H;
  float* acc_m2 = acc_m1 + H;
  float* acc_nw = acc_m2 + H;
  float* acc_nb = acc_nw + H;
  float* acc_lr = acc_nb + H;
  float* acc_li = acc_lr + P;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_tiles = (L + kT - 1) / kT;
  const bool relu_state = a.relu_state != 0;
  const bool layer_relu = a.layer_relu != 0;
  const int bf16 = a.bf16;
  const bool affine = a.nw != nullptr;
  const long long row0 = (long long)b * L * H;
  const float* m1 = a.m1 ? a.m1 + (long long)b * H : nullptr;
  const float* m2 = a.m2 ? a.m2 + (long long)b * H : nullptr;
  float* dwb = a.dwb + (long long)b * H * 2 * P;
  float* dwc = a.dwc + (long long)b * 2 * P * H;
  float* do2k = a.do2k ? a.do2k + (long long)b * H * H : nullptr;
  float* do1k = a.do1k ? a.do1k + (long long)b * H * H : nullptr;
  const float* dvec = a.d;
  const float* o2b = a.o2b;
  const float* o1b = a.o1b;

  for (int i = tid; i < 2 * P; i += blockDim.x) vcarry[i] = 0.f;
  for (int i = tid; i < 7 * H + 2 * P; i += blockDim.x) acc_dd[i] = 0.f;
  __syncthreads();

  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * kT;
    const int rows = min(kT, L - t0);
    const bool first = tile == n_tiles - 1;

    // ======== forward chain of this tile, from its entry state ========
    load_tile(a.x, a.skip, row0, bf16, t0, rows, H, ldh, a.nw, a.nb, XG, Z);
    for (int p = tid; p < P; p += blockDim.x) {
      const long long at = ((long long)b * n_tiles + tile) * P + p;
      entry[p] = fcarry[p] = a.hist_re[at];
      entry[P + p] = fcarry[P + p] = a.hist_im[at];
    }
    __syncthreads();
    tile_matmul(Z, ldh, a.wb, H, 2 * P, rows,
                [&](int r, int c, float acc) { S[r * ldp + c] = acc; });
    __syncthreads();
    // raw states stay in S (d_lam and the relu mask need them); the relu'd
    // states, the C-projection's operand, go to V
    scan_tile(S, ldp, P, rows, a.lam_re, a.lam_im, fcarry, false,
              relu_state ? V : nullptr);
    __syncthreads();
    tile_matmul(relu_state ? V : S, ldp, a.wc, 2 * P, H, rows,
                [&](int r, int c, float acc) {
                  Y[r * ldh + c] = fmaf(dvec[c], Z[r * ldh + c], acc);
                });
    __syncthreads();
    for (int i = tid; i < rows * H; i += blockDim.x) {
      const int r = i / H, c = i % H;
      D[r * ldh + c] = x1_dropped(Y[r * ldh + c], act, m1, c);
    }
    __syncthreads();
    if (glu == kFull) {
      tile_matmul(D, ldh, a.o1k, H, H, rows, [&](int r, int c, float acc) {
        F[r * ldh + c] = acc + o1b[c];
      });
    }
    if (glu != kNone) {
      tile_matmul(D, ldh, a.o2k, H, H, rows, [&](int r, int c, float acc) {
        E[r * ldh + c] = sigmoid_fn(acc + o2b[c]);
      });
    }
    __syncthreads();

    // ======== adjoint chain, top down; a thread owns a column ========
    for (int c = tid; c < H; c += blockDim.x) {
      const float* base_buf = glu == kHalf1 ? D : (glu == kHalf2 ? Y : F);
      const float mask2 = m2 ? m2[c] : 1.f;
      float s_m2 = 0.f, s_o2b = 0.f, s_o1b = 0.f;
      for (int r = 0; r < rows; ++r) {
        const int at = r * ldh + c;
        const float xv = XG[at];   // the residual
        float g = load_stream(a.g, row0 + (long long)(t0 + r) * H + c, bf16);
        if (glu == kNone) {
          if (layer_relu && !(D[at] + xv > 0.f)) g = 0.f;
        } else {
          const float base = base_buf[at], gate = E[at];
          if (layer_relu && !(gated_out(base, gate, m2, c, xv) > 0.f))
            g = 0.f;
          s_m2 += g * (base * gate);
          const float g_h = g * mask2;
          const float g_base = g_h * gate;
          const float g_s = (g_h * base) * gate * (1.f - gate);
          E[at] = g_s;
          F[at] = g_base;
          s_o2b += g_s;
          s_o1b += g_base;
        }
        XG[at] = g;
      }
      acc_m2[c] += s_m2;
      acc_o2b[c] += s_o2b;
      acc_o1b[c] += s_o1b;
    }
    __syncthreads();
    if (glu != kNone) {
      // weight gradients of the GLU denses: x1^T g_s, x1^T g_base
      tile_outer_accum(D, ldh, E, ldh, do2k, H, H, rows, false, first);
      if (glu == kFull)
        tile_outer_accum(D, ldh, F, ldh, do1k, H, H, rows, false, first);
      __syncthreads();
      // g_x1d = g_s @ W2^T (+ g_base | + g_base @ W1^T), into D
      tile_matmul(E, ldh, a.o2kT, H, H, rows, [&](int r, int c, float acc) {
        D[r * ldh + c] = glu == kHalf1 ? acc + F[r * ldh + c] : acc;
      });
      if (glu == kFull) {
        // the same thread owns (r, c) in both products
        tile_matmul(F, ldh, a.o1kT, H, H, rows, [&](int r, int c, float acc) {
          D[r * ldh + c] += acc;
        });
      }
      __syncthreads();
    }
    // g_y = g_x1d * m1 * act'(y) (+ g_base for half2), into E
    for (int c = tid; c < H; c += blockDim.x) {
      const float* gx1d = glu == kNone ? XG : D;
      const float mask1 = m1 ? m1[c] : 1.f;
      float s_m1 = 0.f, s_dd = 0.f;
      for (int r = 0; r < rows; ++r) {
        const int at = r * ldh + c;
        const float y = Y[at];
        const float g1 = gx1d[at];
        s_m1 += g1 * act_fn(y, act);
        float g_y = (g1 * mask1) * act_grad(y, act);
        if (glu == kHalf2) g_y += F[at];
        E[at] = g_y;
        s_dd += g_y * Z[at];
      }
      acc_m1[c] += s_m1;
      acc_dd[c] += s_dd;
    }
    __syncthreads();
    // g_xs = g_y @ W_c^T into V; d_w_c += xs^T g_y (xs = relu'd S)
    tile_matmul(E, ldh, a.wcT, H, 2 * P, rows,
                [&](int r, int c, float acc) { V[r * ldp + c] = acc; });
    tile_outer_accum(S, ldp, E, ldh, dwc, 2 * P, H, rows, relu_state, first);
    __syncthreads();
    // reverse-time recurrence with conj(lam), the carry kept across tiles;
    // d_lam from the previous-step raw states (row 0: the entry state)
    for (int p = tid; p < P; p += blockDim.x) {
      const float lr = a.lam_re[p], li = a.lam_im[p];
      float vr = vcarry[p], vi = vcarry[P + p];
      float s_lr = 0.f, s_li = 0.f;
      for (int r = rows - 1; r >= 0; --r) {
        float gr = V[r * ldp + p], gi = V[r * ldp + P + p];
        if (relu_state) {
          if (!(S[r * ldp + p] > 0.f)) gr = 0.f;
          if (!(S[r * ldp + P + p] > 0.f)) gi = 0.f;
        }
        const float nr = gr + (lr * vr + li * vi);
        const float ni = gi + (lr * vi - li * vr);
        vr = nr;
        vi = ni;
        V[r * ldp + p] = vr;
        V[r * ldp + P + p] = vi;
        const float xpr = r > 0 ? S[(r - 1) * ldp + p] : entry[p];
        const float xpi = r > 0 ? S[(r - 1) * ldp + P + p] : entry[P + p];
        s_lr += vr * xpr + vi * xpi;
        s_li += vi * xpr - vr * xpi;
      }
      vcarry[p] = vr;
      vcarry[P + p] = vi;
      acc_lr[p] += s_lr;
      acc_li[p] += s_li;
    }
    __syncthreads();
    // g_zn = v @ W_b^T + g_y * d into D; d_w_b += z^T v
    tile_matmul(V, ldp, a.wbT, 2 * P, H, rows, [&](int r, int c, float acc) {
      D[r * ldh + c] = fmaf(E[r * ldh + c], dvec[c], acc);
    });
    tile_outer_accum(Z, ldh, V, ldp, dwb, H, 2 * P, rows, false, first);
    __syncthreads();
    // affine: g_x = g_zn * nw + g, d_nw, d_nb; non-affine: g_z = g_zn and
    // g_skip = g (the masked g)
    for (int c = tid; c < H; c += blockDim.x) {
      if (affine) {
        const float w = a.nw[c];
        float s_nw = 0.f, s_nb = 0.f;
        for (int r = 0; r < rows; ++r) {
          const int at = r * ldh + c;
          const long long el = row0 + (long long)(t0 + r) * H + c;
          const float g_zn = D[at];
          s_nw += g_zn * load_stream(a.x, el, bf16);
          s_nb += g_zn;
          store_stream(a.gx, el, fmaf(g_zn, w, XG[at]), bf16);
        }
        acc_nw[c] += s_nw;
        acc_nb[c] += s_nb;
      } else {
        for (int r = 0; r < rows; ++r) {
          const int at = r * ldh + c;
          const long long el = row0 + (long long)(t0 + r) * H + c;
          store_stream(a.gx, el, D[at], bf16);
          store_stream(a.gskip, el, XG[at], bf16);
        }
      }
    }
    __syncthreads();
  }

  for (int c = tid; c < H; c += blockDim.x) {
    const long long at = (long long)b * H + c;
    a.dd[at] = acc_dd[c];
    if (a.dnw) a.dnw[at] = acc_nw[c];
    if (a.dnb) a.dnb[at] = acc_nb[c];
    if (a.do2b) a.do2b[at] = acc_o2b[c];
    if (a.do1b) a.do1b[at] = acc_o1b[c];
    if (a.dm1) a.dm1[at] = acc_m1[c];
    if (a.dm2) a.dm2[at] = acc_m2[c];
  }
  for (int p = tid; p < P; p += blockDim.x) {
    a.dlam_re[(long long)b * P + p] = acc_lr[p];
    a.dlam_im[(long long)b * P + p] = acc_li[p];
  }
}

size_t bwd_smem_bytes(int H, int P) {
  return sizeof(float) * ((size_t)kT * (6 * round4(H) + 2 * round4(2 * P)) +
                          6 * P + 7 * H + 2 * P);
}

}  // namespace

// Entry state of every 32-row time tile. x: (B, L, H), float32 (bf16 = 0)
// or bfloat16 (bf16 = 1): the raw input with nw, nb, or the normed z with
// nw = nb = null; hist_re, hist_im: (B, ceil(L / 32), P). Returns
// cudaGetLastError() after the launch.
extern "C" int layer_tail_hist(const void* x, const float* nw,
                               const float* nb, const float* wb,
                               const float* lam_re, const float* lam_im,
                               float* hist_re, float* hist_im, int B, int L,
                               int H, int P, int bf16, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kT * (round4(H) + round4(2 * P)) + 2 * P);
  cudaError_t err = cudaFuncSetAttribute(
      layer_tail_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  layer_tail_hist_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      x, nw, nb, wb, lam_re, lam_im, hist_re, hist_im, L, H, P, bf16);
  return (int)cudaGetLastError();
}

// The time rows of a tile, so that the wrapper sizes the history.
extern "C" int layer_tail_tile_rows() { return kT; }

// The adjoint. `ptrs` holds the 37 pointers of BwdArgs in declaration order
// (null where the mode, a GLU variant or a missing mask leaves one out); the
// streams x, g, skip, gx, gskip are float32 (bf16 = 0) or bfloat16 (bf16 =
// 1). Returns cudaGetLastError() after the launch.
extern "C" int layer_tail_bwd(const void* const* ptrs, int B, int L, int H,
                              int P, int glu, int act, int relu_state,
                              int layer_relu, int bf16, void* stream) {
  BwdArgs a;
  int i = 0;
  auto in = [&]() { return static_cast<const float*>(ptrs[i++]); };
  auto out = [&]() {
    return const_cast<float*>(static_cast<const float*>(ptrs[i++]));
  };
  a.x = ptrs[i++]; a.g = ptrs[i++]; a.skip = ptrs[i++];
  a.nw = in(); a.nb = in(); a.wb = in(); a.wc = in();
  a.wbT = in(); a.wcT = in(); a.d = in(); a.lam_re = in(); a.lam_im = in();
  a.o2k = in(); a.o2kT = in(); a.o2b = in(); a.o1k = in(); a.o1kT = in();
  a.o1b = in(); a.m1 = in(); a.m2 = in(); a.hist_re = in(); a.hist_im = in();
  a.gx = const_cast<void*>(ptrs[i++]);
  a.gskip = const_cast<void*>(ptrs[i++]);
  a.dwb = out(); a.dwc = out(); a.do2k = out(); a.do1k = out();
  a.dd = out(); a.do2b = out(); a.do1b = out(); a.dm1 = out(); a.dm2 = out();
  a.dnw = out(); a.dnb = out(); a.dlam_re = out(); a.dlam_im = out();
  a.L = L; a.H = H; a.P = P; a.glu = glu; a.act = act;
  a.relu_state = relu_state; a.layer_relu = layer_relu; a.bf16 = bf16;
  const size_t smem = bwd_smem_bytes(H, P);
  cudaError_t err = cudaFuncSetAttribute(
      layer_tail_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  layer_tail_bwd_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
