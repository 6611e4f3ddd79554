// One quantized serving layer per launch, one CTA per batch row, with an
// optional carry in and out, and optionally the encoder dense before the
// layer and the decoder dense after it (the serving stack's first and last
// launch), so that every product of the stack route is summed exactly as
// the whole-network kernel sums it.
//
// Replaces the TPU kernels sparsernns_tpu/ops/pallas/fused_layer.py
// `fused_layer_apply` (pallas_call at :629) and `fused_layer_apply_carry`
// (:729), in float-dot mode and in the integer-dot modes of w8a8 and of
// the w8a16 engine's mxu16 (engine_body.cuh). On the TPU the grid walks the time blocks of a
// row in order with the carry in VMEM scratch, and the block's states come
// from doubling passes over a padded block. Here one CTA owns a row and
// walks tiles of kT frames itself: the recurrence runs in order with the
// state in shared memory, and `block_t` is only where the states are
// requantized and the carry is put on the grid (engine_body.cuh). The
// residual stream is read and written once, as the integer codes of its
// frozen grid (int16 / int8), bf16 or f32; nothing else touches device
// memory but the weights, which are int8 / int16 / f32 and stream from L2.
// The integer dots quantize their operand into a code tile of two int8
// planes in shared memory (Q, kT rows of ldq bytes each).
//
// Bound: operations. Per frame 2*H*2P (B-projection) + 2*2P*H
// (C-projection) + 2*H*H per GLU dense, 0.27 MFLOP at H=192, P=128 with
// half1; at B=8, L=3751 that is 8.1 GFLOP, 0.12 ms at 67 TFLOP/s f32,
// against 23 MB of stream traffic (0.007 ms at 3.35 TB/s). In the int-dot
// modes the dots become int8 operations (two a multiply-add, twice that on
// two planes) at the tensor cores' int8 rate; the scan stays f32. This
// simple design fills B of the 132 SMs, as the float tail kernel does.

#include "engine_body.cuh"

namespace {

using namespace engine;

struct LayerArgs {
  const void* in;        // x (B, L, d_in) with enc, else stream (B, L, H)
  void* out;             // mask (B, L, d_out) with dec, else stream
  const float* ci_re;    // (B, P) carry in, null: zero
  const float* ci_im;
  float* co_re;          // (B, P) carry out, null: not returned
  float* co_im;
  LayerParams layer;
  DenseW enc, dec;       // w null: stage absent
  Mode mode;
  float in_scale;        // stream codes -> values (1 for float streams)
  int in_type, out_type; // IoType
  int d_in, d_out;
  int L, block_t;
  int ldq;               // bytes a row of the code tile Q (0: no int dot)
};

__global__ void __launch_bounds__(kThreads)
engine_layer_kernel(const __grid_constant__ LayerArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const LayerParams& lp = a.layer;
  const int H = a.mode.h, P = lp.p, L = a.L;
  const int ldh = round4(H), ldp = round4(2 * P);
  const int ldx = a.enc.w ? round4(a.d_in) : 0;
  float* R = smem;
  float* Z = R + kT * ldh;
  float* Y = Z + kT * ldh;
  float* S = Y + kT * ldh;
  float* carry = S + kT * ldp;
  float* X = carry + 2 * P;
  int8_t* Q = reinterpret_cast<int8_t*>(X + (a.enc.w ? kT * ldx : 0));

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int w_in = a.enc.w ? a.d_in : H;
  const int w_out = a.dec.w ? a.d_out : H;
  const long long in_row0 = (long long)b * L;

  for (int p = tid; p < P; p += blockDim.x) {
    carry[p] = a.ci_re ? a.ci_re[(long long)b * P + p] : 0.f;
    carry[P + p] = a.ci_im ? a.ci_im[(long long)b * P + p] : 0.f;
  }
  for (int t0 = 0; t0 < L; t0 += kT) {
    const int rows = min(kT, L - t0);
    if (a.enc.w) {
      load_tile(X, ldx, a.in, a.in_type, in_row0 + t0, w_in, rows, 1.f);
      __syncthreads();
      encode_tile(X, ldx, a.enc, a.d_in, a.mode, R, ldh, rows, Q, a.ldq);
    } else {
      load_tile(R, ldh, a.in, a.in_type, in_row0 + t0, H, rows, a.in_scale);
    }
    __syncthreads();
    layer_tile(lp, a.mode, R, Z, Y, S, carry, ldh, ldp, rows, t0, L,
               a.block_t, Q, a.ldq);
    if (a.dec.w) {
      for (int i = tid; i < rows * H; i += blockDim.x) {
        float* v = R + (i / H) * ldh + i % H;
        *v = stream_value(*v, lp, a.mode.act_bf16);
      }
      __syncthreads();
      decode_tile(R, ldh, a.dec, H, a.d_out, a.out, a.out_type, in_row0 + t0,
                  rows, Q, a.ldq);
    } else {
      for (int i = tid; i < rows * H; i += blockDim.x) {
        const float h = R[(i / H) * ldh + i % H];
        store_io(a.out, (in_row0 + t0) * w_out + i, a.out_type,
                 lp.has_rq ? quant_code(h, lp.rq_s, lp.rq_min, lp.rq_max)
                           : h);
      }
    }
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

// in: (B, L, d_in) f32/bf16 when enc->w is set, else the stream (B, L, H)
// of in_type, whose codes are multiplied by in_scale. out: (B, L, d_out)
// f32/bf16 when dec->w is set, else the stream of out_type (the codes of
// the layer's output requant when it has one, else the activation type).
// Carries (B, P) f32, null pointers for none. Returns cudaGetLastError().
extern "C" int engine_layer_fwd(
    const void* in, void* out, int in_type, int out_type, float in_scale,
    const engine::LayerParams* layer, const engine::Mode* mode,
    const engine::DenseW* enc, int d_in, const engine::DenseW* dec, int d_out,
    const float* ci_re, const float* ci_im, float* co_re, float* co_im,
    int B, int L, int block_t, void* stream) {
  LayerArgs a;
  a.in = in;
  a.out = out;
  a.ci_re = ci_re;
  a.ci_im = ci_im;
  a.co_re = co_re;
  a.co_im = co_im;
  a.layer = *layer;
  a.enc = *enc;
  a.dec = *dec;
  a.mode = *mode;
  a.in_scale = in_scale;
  a.in_type = in_type;
  a.out_type = out_type;
  a.d_in = d_in;
  a.d_out = d_out;
  a.L = L;
  a.block_t = block_t;
  const int H = mode->h, P = layer->p;
  int q_w = engine::code_width(*layer, H);
  if (enc->in_mode) q_w = engine::imax(q_w, d_in);
  if (dec->in_mode) q_w = engine::imax(q_w, H);
  a.ldq = engine::round4(q_w);
  const size_t smem =
      sizeof(float) * ((size_t)engine::kT *
                           (3 * engine::round4(H) + engine::round4(2 * P) +
                            (enc->w ? engine::round4(d_in) : 0)) +
                       2 * P) +
      2 * (size_t)engine::kT * a.ldq;
  cudaError_t err = cudaFuncSetAttribute(
      engine_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  engine_layer_kernel<<<B, engine::kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
