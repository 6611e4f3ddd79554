// K6: the whole serving network, encoder dense (+ relu), every layer,
// decoder dense, as passes over the whole card (engine_passes.cuh): a row
// pass runs the tail of layer l and the head of layer l + 1 on a tile of
// 32 frames of the flattened B * L stream, a scan pass walks each (batch
// row, state channel) through all of L. n_layers + 1 row passes and
// n_layers scans, enqueued by one call.
//
// Replaces the TPU kernel sparsernns_tpu/ops/pallas/fused_network.py
// `fused_network_apply` -> `_net_call` (pallas_call at :299, main and tail
// calls), in float-dot mode and in the integer-dot modes (the encoder's and
// decoder's `_boundary_dense` :125 and every layer's, engine_body.cuh). The
// TPU version walks 8-aligned time blocks of a row in order with every
// layer's carry in VMEM (plus a tail call chained by carries), so the
// stream never leaves the core. Here the row passes have no order and the
// recurrence is a pass of its own: between passes the stream (float32
// values) and bu / the scanned states (float32) go through device memory,
// in scratch the wrapper allocates ((B, L, H) and (B, L, 2P), updated in
// place). `block_t` only says where the states are requantized. Every
// product and requantization goes through the same device functions as
// engine_layer.cu, so the two routes are bit-identical at the same
// block_t.
//
// Bound: operations. Per frame 2*d_in*H (encoder) + n_layers * 0.27 MFLOP
// + 2*H*d_out (decoder), 1.0 MFLOP at the serving width; at B=8, L=3751
// that is 30 GFLOP, 0.45 ms at 67 TFLOP/s f32, against 62 MB of input and
// mask traffic (0.018 ms at 3.35 TB/s); the scratch adds 2 x (H + 2P) x 4
// bytes a frame and layer (52 MB a layer at B=8). The int-dot modes count
// their dots as int8 operations (engine_layer.cu). A row pass is
// ceil(B * L / 32) CTAs (938 at B=8), two an SM where shared memory allows;
// a scan is B * P / 32 one-warp CTAs, latency-bound like K1. The int8
// float dots with the engine's fragments run on the tensor cores over
// exact bf16 planes, the other float dots as fmaf tiles, the integer dots
// by __dp4a (engine_body.cuh).

#include "engine_passes.cuh"

using namespace engine;

namespace {

constexpr int kMaxLayers = 8;

}  // namespace

// x: (B, L, d_in) of in_type (f32 / bf16); out: (B, L, d_out) of out_type.
// layers: n_layers (<= 8) host structs. bu: (B * L, 2 * the widest P) f32
// and stream: (B * L, H) f32 scratch. Returns the error of the first
// launch that fails, cudaErrorInvalidValue for too many layers, or 0.
extern "C" int engine_network_fwd(
    const void* x, void* out, int in_type, int out_type,
    const engine::LayerParams* layers, int n_layers,
    const engine::Mode* mode, const engine::DenseW* enc, int d_in,
    const engine::DenseW* dec, int d_out, int B, int L, int block_t,
    float* bu, float* stream_buf, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int p_max = 0;
  for (int l = 0; l < n_layers; ++l) p_max = imax(p_max, layers[l].p);
  RowPass base = {};
  base.mode = *mode;
  base.n_rows = (long long)B * L;
  base.in_scale = 1.f;
  base.d_in = d_in;
  base.d_out = d_out;
  base.ld_bu = 2 * p_max;
  base.ldp = round4(base.ld_bu);
  g_n_launched = 0;
  cudaError_t err;
  for (int l = 0; l <= n_layers; ++l) {
    RowPass a = base;
    if (l == 0) {          // encoder -> head of layer 0
      a.in = x;
      a.in_type = in_type;
      a.enc = *enc;
    } else {               // tail of layer l - 1
      a.in = stream_buf;
      a.in_type = kIoF32;
      a.has_tail = 1;
      a.tail = layers[l - 1];
      a.s_in = bu;
    }
    if (l < n_layers) {    // -> the stream, head of layer l
      a.stream_out = stream_buf;
      a.has_head = 1;
      a.head = layers[l];
      a.bu_out = bu;
    } else {               // -> decoder
      a.dec = *dec;
      a.out = out;
      a.out_type = out_type;
    }
    if ((err = launch_row_pass(a, st)) != cudaSuccess) return (int)err;
    if (l == n_layers) break;
    ScanPass s = {};
    s.lp = layers[l];
    s.S = bu;
    s.ld = base.ld_bu;
    s.B = B;
    s.L = L;
    s.block_t = block_t;
    if ((err = launch_scan_pass(s, st)) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The passes of the last call: see engine::read_launched.
extern "C" int engine_network_launched(const char** names, long long* ctas,
                                       int cap) {
  return read_launched(names, ctas, cap);
}

// The same passes' dense products on the tensor cores and as fmaf tiles:
// see engine::read_launched_dots.
extern "C" int engine_network_launched_dots(int* mma, int* fmaf, int cap) {
  return read_launched_dots(mma, fmaf, cap);
}
