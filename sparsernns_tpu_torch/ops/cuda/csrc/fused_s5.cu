// The S5 mixer in one kernel, one CTA per batch row, with an optional carry
// in and out:
//
//   bu = (u @ W_b) * (s_b_re | s_b_im)      (weights int8 / int16 / f32)
//   x_t = lam * x_{t-1} + bu_t              (f32, in order over time)
//   with a state grid, every `block_t` frames: all states of the block on
//     the frozen grid (s_re, s_im, bits), the requantized last state the
//     carry onward
//   y = [relu?(x_re) * s_c_re | relu?(x_im) * s_c_im] @ W_c + d * u
//
// Replaces the TPU kernels sparsernns_tpu/ops/pallas/fused_s5.py
// `fused_s5_apply` (pallas_call at :258) in all its modes but `qat_bits`:
// the float mode (f32 weights without scales, f32 u, no state grid) of the
// float models' mixer route, and the engine modes (int8 / int16 weights
// with static per-half pow2 scales, a bf16 or f32 input, `block_requant`)
// of the engine's per-op route; with a carry `fused_s5_apply_carry` (:327).
// On the TPU the grid walks the time blocks of a row in order with the
// carry in VMEM scratch, and a block's states come from doubling passes
// with tables of powers of lam. Here one CTA owns a row and walks tiles of
// kT frames itself, the carry in shared memory; the time block is only
// where states are requantized. Every step is engine_body.cuh's
// `mixer_tile`, the mixer of the whole-layer serving kernels
// (engine_layer.cu, engine_network.cu), so the per-op route and the stack
// route round alike, and a chunked call at chunk = block equals one whole
// call bit for bit. Each product and sum of the scan is rounded on its own
// (scan_step_rn), as in the plain recurrence.
//
// Only u is read (f32 or bf16) and only y written (f32): the states never
// reach device memory. Per tile the input, the output and the states live
// in shared memory (kT*(2H + 2P) floats, 82 KB at H=192, P=128); W_b and
// W_c stream from L2 in their storage type and are scaled on the result.
// Plain f32 FMA on the CUDA cores, no tensor cores.
//
// Bound: operations. Per row 2*H*2P (B-projection) + 2*2P*H
// (C-projection) = 196,608 flop at H=192, P=128; at B=8, L=3751 that is
// 5.9 GFLOP, 0.088 ms at the card's 67 TFLOP/s f32 peak, against 46 MB of
// device memory traffic (u read, y written), 0.014 ms at 3.35 TB/s.
// B CTAs in all fill B of the 132 SMs, as for the other serving kernels.

#include "engine_body.cuh"

namespace {

using namespace engine;

struct MixerArgs {
  const void* u;         // (B, L, H) f32 or bf16
  float* y;              // (B, L, H) f32
  const float* ci_re;    // (B, P) carry in, null: zero
  const float* ci_im;
  float* co_re;          // (B, P) carry out, null: not returned
  float* co_im;
  LayerParams mixer;     // lam, d, W_b, W_c, scales, state grid
  int relu_state, in_type, H, L, block_t;
};

__global__ void __launch_bounds__(kThreads)
fused_s5_kernel(const __grid_constant__ MixerArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const LayerParams& lp = a.mixer;
  const int H = a.H, P = lp.p, L = a.L;
  const int ldh = round4(H), ldp = round4(2 * P);
  float* Z = smem;
  float* Y = Z + kT * ldh;
  float* S = Y + kT * ldh;
  float* carry = S + kT * ldp;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long row0 = (long long)b * L;
  for (int p = tid; p < P; p += blockDim.x) {
    carry[p] = a.ci_re ? a.ci_re[(long long)b * P + p] : 0.f;
    carry[P + p] = a.ci_im ? a.ci_im[(long long)b * P + p] : 0.f;
  }
  for (int t0 = 0; t0 < L; t0 += kT) {
    const int rows = min(kT, L - t0);
    load_tile(Z, ldh, a.u, a.in_type, row0 + t0, H, rows, 1.f);
    __syncthreads();
    mixer_tile(lp, a.relu_state, H, Z, Y, S, carry, ldh, ldp, rows, t0, L,
               a.block_t);
    for (int i = tid; i < rows * H; i += blockDim.x)
      a.y[(row0 + t0) * H + i] = Y[(i / H) * ldh + i % H];
    __syncthreads();
  }
  if (a.co_re) {
    for (int p = tid; p < P; p += blockDim.x) {
      a.co_re[(long long)b * P + p] = carry[p];
      a.co_im[(long long)b * P + p] = carry[P + p];
    }
  }
}

}  // namespace

// u: (B, L, H) of in_type (IoType f32 or bf16); y: (B, L, H) f32. mixer:
// lam, d, wb, wc, the per-half scales (1 for float weights) and the state
// grid (has_sq 0: none; nw, nb and the GLU fields are not read). Carries
// (B, P) f32, null pointers for none. Returns cudaGetLastError() after the
// launch.
extern "C" int fused_s5_fwd(
    const void* u, float* y, int in_type, const engine::LayerParams* mixer,
    int relu_state, const float* ci_re, const float* ci_im, float* co_re,
    float* co_im, int B, int L, int H, int block_t, void* stream) {
  MixerArgs a;
  a.u = u;
  a.y = y;
  a.ci_re = ci_re;
  a.ci_im = ci_im;
  a.co_re = co_re;
  a.co_im = co_im;
  a.mixer = *mixer;
  a.relu_state = relu_state;
  a.in_type = in_type;
  a.H = H;
  a.L = L;
  a.block_t = block_t;
  const int P = mixer->p;
  const size_t smem =
      sizeof(float) *
      ((size_t)engine::kT * (2 * engine::round4(H) + engine::round4(2 * P)) +
       2 * P);
  cudaError_t err = cudaFuncSetAttribute(
      fused_s5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_s5_kernel<<<B, engine::kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
