// K5a / K5b: one quantized serving layer, with an optional carry in and
// out, and optionally the encoder dense before the layer and the decoder
// dense after it (the serving stack's first and last launch), so that
// every product of the stack route is summed exactly as the whole-network
// kernel sums it. Three passes over the whole card (engine_passes.cuh),
// enqueued by one call: a row pass (the stream as stored, or the encoder,
// -> the layer's head -> bu), the scan (carry in and out) and a row pass
// (the layer's tail -> the stream's codes, or the decoder's output).
//
// Replaces the TPU kernels sparsernns_tpu/ops/pallas/fused_layer.py
// `fused_layer_apply` (pallas_call at :629) and `fused_layer_apply_carry`
// (:729), in float-dot mode and in the integer-dot modes of w8a8 and of
// the w8a16 engine's mxu16 (engine_body.cuh). On the TPU the grid walks the
// time blocks of a row in order with the carry in VMEM scratch, and the
// block's states come from doubling passes over a padded block. Here the
// row passes take tiles of 32 frames of the flattened B * L stream in no
// order, and the recurrence runs in a pass of its own, one thread per
// (batch row, state channel) walking all L in order; `block_t` is only
// where the states are requantized and the carry is put on the grid. The
// residual stream is read as the integer codes of its frozen grid (int16 /
// int8), bf16 or f32 (twice: the tail recomputes z) and written once;
// bu / the states (B, L, 2P) f32 and, after an encoder, the stream values
// (B, L, H) f32 go through scratch the wrapper allocates. The integer dots
// quantize their operand into a code tile of two int8 planes in shared
// memory.
//
// Bound: operations. Per frame 2*H*2P (B-projection) + 2*2P*H
// (C-projection) + 2*H*H per GLU dense, 0.27 MFLOP at H=192, P=128 with
// half1; at B=8, L=3751 that is 8.1 GFLOP, 0.12 ms at 67 TFLOP/s f32,
// against 23 MB of stream traffic (0.007 ms at 3.35 TB/s; the scratch adds
// 15 MB). In the int-dot modes the dots become int8 operations (two a
// multiply-add, twice that on two planes) at the tensor cores' int8 rate;
// the scan stays f32. A row pass is ceil(B * L / 32) CTAs (938 at B=8,
// 32 for one 128-frame block), a scan B * P / 32 one-warp CTAs.

#include "engine_passes.cuh"

using namespace engine;

// in: (B, L, d_in) f32/bf16 when enc->w is set, else the stream (B, L, H)
// of in_type, whose codes are multiplied by in_scale. out: (B, L, d_out)
// f32/bf16 when dec->w is set, else the stream of out_type (the codes of
// the layer's output requant when it has one, else the activation type).
// Carries (B, P) f32, null pointers for none. bu: (B * L, 2P) f32 scratch;
// stream: (B * L, H) f32 scratch where enc->w is set, else unused. Returns
// the error of the first launch that fails, or 0.
extern "C" int engine_layer_fwd(
    const void* in, void* out, int in_type, int out_type, float in_scale,
    const engine::LayerParams* layer, const engine::Mode* mode,
    const engine::DenseW* enc, int d_in, const engine::DenseW* dec, int d_out,
    const float* ci_re, const float* ci_im, float* co_re, float* co_im,
    int B, int L, int block_t, float* bu, float* stream_buf, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  RowPass base = {};
  base.mode = *mode;
  base.n_rows = (long long)B * L;
  base.d_in = d_in;
  base.d_out = d_out;
  base.ld_bu = 2 * layer->p;
  base.ldp = round4(base.ld_bu);
  g_n_launched = 0;
  cudaError_t err;
  // ---- the stream (or the encoder) -> the layer's head ----
  RowPass a = base;
  a.in = in;
  a.in_type = in_type;
  a.in_scale = enc->w ? 1.f : in_scale;
  a.enc = *enc;
  a.stream_out = enc->w ? stream_buf : nullptr;
  a.has_head = 1;
  a.head = *layer;
  a.bu_out = bu;
  if ((err = launch_row_pass(a, st)) != cudaSuccess) return (int)err;
  // ---- the recurrence ----
  ScanPass s = {};
  s.lp = *layer;
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
  // ---- the layer's tail -> the stream's codes, or the decoder ----
  a = base;
  if (enc->w) {
    a.in = stream_buf;
    a.in_type = kIoF32;
    a.in_scale = 1.f;
  } else {
    a.in = in;
    a.in_type = in_type;
    a.in_scale = in_scale;
  }
  a.has_tail = 1;
  a.tail = *layer;
  a.s_in = bu;
  a.out = out;
  a.out_type = out_type;
  if (dec->w)
    a.dec = *dec;
  else
    a.codes_out = 1;
  if ((err = launch_row_pass(a, st)) != cudaSuccess) return (int)err;
  return 0;
}

// The passes of the last call: see engine::read_launched.
extern "C" int engine_layer_launched(const char** names, long long* ctas,
                                     int cap) {
  return read_launched(names, ctas, cap);
}

// The same passes' dense products on the tensor cores and as fmaf tiles:
// see engine::read_launched_dots.
extern "C" int engine_layer_launched_dots(int* mma, int* fmaf, int cap) {
  return read_launched_dots(mma, fmaf, cap);
}
