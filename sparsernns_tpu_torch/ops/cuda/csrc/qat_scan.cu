// The QAT modes of the diagonal scan (K1) and of the S5 mixer (K4a): the
// scan with in-scan activation fake-quant over time blocks of t rows,
// L padded with zero rows to a multiple of t (qat_scan.cuh has the
// numerics).
//
// Replaces the TPU kernels sparsernns_tpu/ops/pallas/scan_kernel.py
// `pallas_diag_scan` (pallas_call at :494) with `qat_bits`, in both
// directions and with a carry, and sparsernns_tpu/ops/pallas/fused_s5.py
// `fused_s5_apply` (pallas_call at :258) with `qat_bits` and
// `qat_state_scale`. On the TPU the grid walks a row's time blocks in
// order, each block resident in VMEM, the carry in scratch. Here a block
// (t x 2P floats: 256 KB at t = 256, P = 128) does not fit in the 227 KB
// of shared memory a CTA may use, and the passes of one block need no
// carry, so a mode is three launches:
//
//   A  one CTA per (batch row, block): load the block (K1: bu, flipped for
//      the reverse direction, lam*carry added to the first row; K4a: its
//      rows of bu = u @ W_b, by engine_body.cuh's tile_matmul over tiles of
//      kT rows) into a device-memory scratch, then the doubling passes,
//      ping-ponging between two scratch buffers, with a CTA-wide absmax
//      reduction before each pass;
//   B  one CTA per batch row: the carry walk over the row's blocks in
//      order (carry fake-quant, fold, block absmax, output fake-quant);
//      K1 writes the states out (unflipped, unpadded), K4a back into the
//      scratch;
//   C  (K4a) one CTA per (batch row, tile of kT rows): relu if relu_state,
//      y = [x_re x_im] @ W_c + d * u by tile_matmul.
//
// Bound. K1: bytes, as the float K1 (bu read once, the states written
// once: 61.5 MB at B=8, L=3751, P=128); K4a: operations, the float K4a's
// two projections (5.9 GFLOP at B=8, L=3751, H=192, P=128) plus the
// passes. This design moves far more: every pass reads and writes the
// block in the scratch (31 MB at B=8, t=512, mostly L2-resident on the
// card's 50 MB), and phase B walks a row's blocks in order on B CTAs.
// Keeping a block in the shared memory of a CTA cluster is the way to the
// bound.

#include "engine_body.cuh"
#include "qat_scan.cuh"

namespace {

using qat::Grid;

// ---- K1, phase A: load a block of bu, then the passes ----
__global__ void __launch_bounds__(qat::kThreads)
scan_passes_kernel(const float* __restrict__ bu_re,
                   const float* __restrict__ bu_im, long long sb,
                   long long st, const float* __restrict__ lam_re,
                   const float* __restrict__ lam_im,
                   const float* __restrict__ c_re,
                   const float* __restrict__ c_im,
                   const float* __restrict__ pow_re,
                   const float* __restrict__ pow_im, int num_passes,
                   float* x0, float* x1, int L, int L_pad, int P, int t,
                   int reverse, Grid g) {
  const int j = blockIdx.x, b = blockIdx.y;
  const long long blk0 = ((long long)b * L_pad + (long long)j * t) * 2 * P;
  float2 m = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < t * P; i += blockDim.x) {
    const int r = i / P, p = i - r * P;
    const int row = j * t + r;   // in the (flipped) padded sequence
    float vr = 0.f, vi = 0.f;
    if (row < L) {
      const long long tau = reverse ? L - 1 - row : row;
      const long long at = b * sb + tau * st + p;
      vr = bu_re[at];
      vi = bu_im[at];
      if (c_re != nullptr && tau == 0) {   // x_0 = lam * c + bu_0
        const float lr = lam_re[p], li = lam_im[p];
        const float cr = c_re[(long long)b * P + p];
        const float ci = c_im[(long long)b * P + p];
        vr = __fadd_rn(vr, __fsub_rn(__fmul_rn(lr, cr), __fmul_rn(li, ci)));
        vi = __fadd_rn(vi, __fadd_rn(__fmul_rn(lr, ci), __fmul_rn(li, cr)));
      }
    }
    x0[blk0 + (long long)r * 2 * P + p] = vr;
    x0[blk0 + (long long)r * 2 * P + P + p] = vi;
    if (r < t - 1) {
      m.x = fmaxf(m.x, fabsf(vr));
      m.y = fmaxf(m.y, fabsf(vi));
    }
  }
  m = qat::cta_max2(m);
  qat::doubling_passes(x0, x1, blk0, t, P, pow_re, pow_im, num_passes, g,
                       -1.f, m);
}

// ---- K1, phase B: the carry walk, states out ----
__global__ void __launch_bounds__(qat::kThreads)
scan_carry_kernel(const float* x, const float* __restrict__ ct_re,
                  const float* __restrict__ ct_im, float* __restrict__ out_re,
                  float* __restrict__ out_im, int L, int L_pad, int P,
                  int t, int reverse, Grid g) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  const float* row = x + (long long)b * L_pad * 2 * P;
  float* o_re = out_re + (long long)b * L * P;
  float* o_im = out_im + (long long)b * L * P;
  qat::carry_walk(row, L_pad / t, t, P, ct_re, ct_im, g, -1.f,
                  reinterpret_cast<float*>(smem4),
                  [&](int r, int p, float vr, float vi) {
                    if (r >= L) return;
                    const long long tau = reverse ? L - 1 - r : r;
                    o_re[tau * P + p] = vr;
                    o_im[tau * P + p] = vi;
                  });
}

// ---- K4a, phase A: bu = u @ W_b for the block's rows, then the passes --
__global__ void __launch_bounds__(qat::kMixThreads)
mixer_passes_kernel(const float* __restrict__ u, const float* __restrict__ wb,
                    const float* __restrict__ pow_re,
                    const float* __restrict__ pow_im, int num_passes,
                    const float* __restrict__ gmax_ptr, float* x0, float* x1,
                    int L, int L_pad, int H, int P, int t, Grid g) {
  extern __shared__ float4 smem4[];
  float* U = reinterpret_cast<float*>(smem4);
  const int ldh = engine::round4(H);
  const int j = blockIdx.x, b = blockIdx.y;
  const long long blk0 = ((long long)b * L_pad + (long long)j * t) * 2 * P;
  float2 m = make_float2(0.f, 0.f);
  for (int r0 = 0; r0 < t; r0 += engine::kT) {
    const int row0 = j * t + r0;
    const int rows = max(0, min(engine::kT, min(t - r0, L - row0)));
    if (rows > 0) {
      engine::load_tile(U, ldh, u, engine::kIoF32, (long long)b * L + row0,
                        H, rows, 1.f);
      __syncthreads();
      engine::tile_matmul_t(U, ldh, wb, H, 2 * P, rows,
                            [&](int r, int c, float acc) {
        x0[blk0 + (long long)(r0 + r) * 2 * P + c] = acc;
        if (r0 + r < t - 1) {
          if (c < P)
            m.x = fmaxf(m.x, fabsf(acc));
          else
            m.y = fmaxf(m.y, fabsf(acc));
        }
      });
      __syncthreads();
    }
    // the padding rows past L: zero bu, as u @ W_b of zero rows
    const int zr0 = r0 + max(rows, 0);
    const int zrows = min(engine::kT, t - r0) - max(rows, 0);
    for (int i = threadIdx.x; i < zrows * 2 * P; i += blockDim.x)
      x0[blk0 + (long long)zr0 * 2 * P + i] = 0.f;
  }
  m = qat::cta_max2(m);
  qat::doubling_passes(x0, x1, blk0, t, P, pow_re, pow_im, num_passes, g,
                       gmax_ptr != nullptr ? *gmax_ptr : -1.f, m);
}

// ---- K4a, phase B: the carry walk, states back into the scratch ----
__global__ void __launch_bounds__(qat::kThreads)
mixer_carry_kernel(float* x, const float* __restrict__ ct_re,
                   const float* __restrict__ ct_im,
                   const float* __restrict__ gmax_ptr, int L_pad, int P,
                   int t, Grid g) {
  extern __shared__ float4 smem4[];
  float* row = x + (long long)blockIdx.x * L_pad * 2 * P;
  qat::carry_walk(row, L_pad / t, t, P, ct_re, ct_im, g,
                  gmax_ptr != nullptr ? *gmax_ptr : -1.f,
                  reinterpret_cast<float*>(smem4),
                  [&](int r, int p, float vr, float vi) {
                    row[(long long)r * 2 * P + p] = vr;
                    row[(long long)r * 2 * P + P + p] = vi;
                  });
}

// ---- K4a, phase C: relu, C-projection, d * u ----
__global__ void __launch_bounds__(engine::kThreads)
mixer_out_kernel(const float* __restrict__ x, const float* __restrict__ u,
                 const float* __restrict__ wc, const float* __restrict__ d,
                 float* __restrict__ y, int L, int L_pad, int H, int P,
                 int relu_state) {
  extern __shared__ float4 smem4[];
  const int ldh = engine::round4(H), ldp = engine::round4(2 * P);
  float* S = reinterpret_cast<float*>(smem4);
  float* U = S + engine::kT * ldp;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * engine::kT;
  const int rows = min(engine::kT, L - t0);
  for (int i = threadIdx.x; i < rows * 2 * P; i += blockDim.x) {
    const int r = i / (2 * P), c = i - r * 2 * P;
    const float v = x[((long long)b * L_pad + t0 + r) * 2 * P + c];
    S[r * ldp + c] = relu_state ? fmaxf(v, 0.f) : v;
  }
  engine::load_tile(U, ldh, u, engine::kIoF32, (long long)b * L + t0, H,
                    rows, 1.f);
  __syncthreads();
  float* yb = y + ((long long)b * L + t0) * H;
  engine::tile_matmul_t(S, ldp, wc, 2 * P, H, rows,
                        [&](int r, int c, float acc) {
    yb[(long long)r * H + c] = __fadd_rn(acc, __fmul_rn(d[c], U[r * ldh + c]));
  });
}

size_t carry_smem(int P) { return sizeof(float) * 4 * (size_t)P; }

}  // namespace

// K1 in its QAT mode. bu_re/bu_im: (B, L, P) views with element strides
// (sb, st, 1); lam (P); c_re/c_im: (B, P) contiguous or null (forward only:
// the caller refuses a carry with reverse); pow_re/pow_im: (num_passes, P)
// tables of lam^(2^k); ctab_re/ctab_im: (t, P) table of lam^(r+1), both
// already fake-quantized; x0, x1: (B, L_pad, 2P) scratch, L_pad = L
// rounded up to a multiple of t; out_re/out_im: (B, L, P) contiguous.
// act_bits >= 32: no state fake-quant. Returns the first launch error.
extern "C" int qat_scan_run(
    const float* bu_re, const float* bu_im, long long sb, long long st,
    const float* lam_re, const float* lam_im, const float* c_re,
    const float* c_im, const float* pow_re, const float* pow_im,
    int num_passes, const float* ctab_re, const float* ctab_im, float* x0,
    float* x1, float* out_re, float* out_im, int B, int L, int P, int t,
    int reverse, int act_bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Grid g = qat::make_grid(act_bits);
  const int L_pad = (L + t - 1) / t * t;
  scan_passes_kernel<<<dim3(L_pad / t, B), qat::kThreads, 0, s>>>(
      bu_re, bu_im, sb, st, lam_re, lam_im, c_re, c_im, pow_re, pow_im,
      num_passes, x0, x1, L, L_pad, P, t, reverse, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_carry_kernel<<<B, qat::kThreads, carry_smem(P), s>>>(
      (num_passes & 1) ? x1 : x0, ctab_re, ctab_im, out_re, out_im, L, L_pad,
      P, t, reverse, g);
  return (int)cudaGetLastError();
}

// K4a in its QAT mode. u: (B, L, H); w_b (H, 2P) [B_re^T | B_im^T]; w_c
// (2P, H) with the conj-sym factor folded in; d (H); tables as for
// qat_scan_run; amax: a device scalar, the global state absmax, or null
// for per-block scales; x0, x1: (B, L_pad, 2P) scratch; y: (B, L, H). All
// f32 and contiguous. Returns the first launch error.
extern "C" int fused_s5_qat_run(
    const float* u, const float* w_b, const float* w_c, const float* d,
    const float* pow_re, const float* pow_im, int num_passes,
    const float* ctab_re, const float* ctab_im, const float* amax, float* x0,
    float* x1, float* y, int B, int L, int H, int P, int t, int relu_state,
    int act_bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Grid g = qat::make_grid(act_bits);
  const int L_pad = (L + t - 1) / t * t;
  const size_t smem_a = sizeof(float) * engine::kT * engine::round4(H);
  cudaError_t err = cudaFuncSetAttribute(
      mixer_passes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  mixer_passes_kernel<<<dim3(L_pad / t, B), qat::kMixThreads, smem_a, s>>>(
      u, w_b, pow_re, pow_im, num_passes, amax, x0, x1, L, L_pad, H, P, t,
      g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  float* states = (num_passes & 1) ? x1 : x0;
  mixer_carry_kernel<<<B, qat::kThreads, carry_smem(P), s>>>(
      states, ctab_re, ctab_im, amax, L_pad, P, t, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem_c =
      sizeof(float) * engine::kT *
      (engine::round4(2 * P) + engine::round4(H));
  err = cudaFuncSetAttribute(mixer_out_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  mixer_out_kernel<<<dim3((L + engine::kT - 1) / engine::kT, B),
                     engine::kThreads, smem_c, s>>>(
      states, u, w_c, d, y, L, L_pad, H, P, relu_state);
  return (int)cudaGetLastError();
}
