// K4a / K4b: the S5 mixer alone, with an optional carry in and out, as
// three passes over the whole card:
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
// with tables of powers of lam. Only the recurrence couples frames, so here
// the mixer runs as the serving layer's passes (engine_passes.cuh) with
// the layer around it switched off (no norm, GLU, residual or stream
// requant):
//
//   head row pass  a CTA per 32 consecutive rows of the flattened B*L
//                  stream (938 CTAs at B = 8), u -> bu (mixer_bproj) into
//                  scratch (B*L, 2P) f32 that the wrapper allocates;
//   scan pass      a thread per (batch row, channel) over all of L
//                  (scan_step_rn), the raw states in place of bu, the carry
//                  on the grid where a block ends, the carry in and out;
//   tail row pass  u again, each state on the grid, relu and the C-side
//                  scale as the pass loads it (mixer_grid, mixer_read),
//                  mixer_cproj + d * u -> y, stored as f32. Its tile of u,
//                  y and the states takes 32 x (2H + 2P) floats of shared
//                  memory (80 KB at H=192, P=128; H up to 780 at P=128).
//
// These are the device functions of the whole-layer serving kernels
// (engine_layer.cu, engine_network.cu), in the same order, so the per-op
// route and the stack route round alike, and a chunked call at chunk =
// block equals one whole call bit for bit. A product over int8 weights
// with the engine's fragments runs on the tensor cores over exact bf16
// planes, any other as fmaf chains over k in ascending order from 0
// (engine_body.cuh tile_matmul); each product and sum of the scan is
// rounded on its own (scan_step_rn), as in the plain recurrence. Each
// launch is recorded with its grid; fused_s5_launched hands the wrapper
// the record of the last call.
//
// Bound: operations. Per row 2*H*2P (B-projection) + 2*2P*H
// (C-projection) = 196,608 flop at H=192, P=128; at B=8, L=3751 that is
// 5.9 GFLOP, 0.088 ms at the card's 67 TFLOP/s f32 peak, against 46 MB of
// device memory traffic (u read, y written; bu / the states add 31 MB
// written and read twice), 0.014 ms at 3.35 TB/s.

#include "engine_passes.cuh"

using namespace engine;

// u: (B, L, H) of in_type (IoType f32 or bf16); y: (B, L, H) f32. mixer:
// lam, d, wb, wc, the per-half scales (1 for float weights) and the state
// grid (has_sq 0: none; nw, nb and the GLU fields are not read). Carries
// (B, P) f32, null pointers for none. bu: (B * L, 2P) f32 scratch. Returns
// the error of the first launch that fails, or 0.
extern "C" int fused_s5_fwd(
    const void* u, float* y, int in_type, const engine::LayerParams* mixer,
    int relu_state, const float* ci_re, const float* ci_im, float* co_re,
    float* co_im, int B, int L, int H, int block_t, float* bu,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  RowPass base = {};
  base.mode.h = H;
  base.mode.glu = kNone;
  base.mode.relu_state = relu_state;
  base.n_rows = (long long)B * L;
  base.ld_bu = 2 * mixer->p;
  base.ldp = round4(base.ld_bu);
  base.in = u;
  base.in_type = in_type;
  base.in_scale = 1.f;
  g_n_launched = 0;
  cudaError_t err;
  // ---- u -> bu ----
  RowPass a = base;
  a.has_head = 1;
  a.head = *mixer;
  a.bu_out = bu;
  if ((err = launch_row_pass(a, st)) != cudaSuccess) return (int)err;
  // ---- the recurrence, the carry in and out ----
  ScanPass s = {};
  s.lp = *mixer;
  s.S = bu;
  s.ld = base.ld_bu;
  s.ci_re = ci_re;
  s.ci_im = ci_im;
  s.co_re = co_re;
  s.co_im = co_im;
  s.B = B;
  s.L = L;
  s.block_t = block_t;
  if ((err = launch_scan_pass(s, st)) != cudaSuccess) return (int)err;
  // ---- the states and u -> y ----
  a = base;
  a.has_tail = 1;
  a.tail = *mixer;
  a.s_in = bu;
  a.y_out = y;
  if ((err = launch_row_pass(a, st)) != cudaSuccess) return (int)err;
  return 0;
}

// The passes of the last call: see engine::read_launched.
extern "C" int fused_s5_launched(const char** names, long long* ctas,
                                 int cap) {
  return read_launched(names, ctas, cap);
}

// The same passes' dense products on the tensor cores and as fmaf tiles:
// see engine::read_launched_dots.
extern "C" int fused_s5_launched_dots(int* mma, int* fmaf, int cap) {
  return read_launched_dots(mma, fmaf, cap);
}
