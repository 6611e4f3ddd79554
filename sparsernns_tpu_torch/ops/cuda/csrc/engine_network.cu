// The whole serving network per launch, one CTA per batch row: encoder
// dense (+ relu), every layer, decoder dense, per tile of kT frames, with
// every layer's scan state resident in shared memory and the stream
// between layers never leaving the SM.
//
// Replaces the TPU kernel sparsernns_tpu/ops/pallas/fused_network.py
// `fused_network_apply` -> `_net_call` (pallas_call at :299, main and tail
// calls), in float-dot mode and in the integer-dot modes (the encoder's and
// decoder's `_boundary_dense` :125 and every layer's, engine_body.cuh). The
// TPU version needs a main grid of 8-aligned time blocks plus a
// tail call chained by carries, and lambda-power tables per block size;
// here one launch covers all of L, and `block_t` only says where the
// states are requantized (engine_body.cuh). The store and load of the
// stream between two layers of the per-layer route (integer codes of the
// residual grid, or the activation type) happens as values:
// `stream_value`. Every product and requantization goes through the same
// device functions as engine_layer.cu, so the two routes are bit-identical
// at the same block_t.
//
// Bound: operations. Per frame 2*d_in*H (encoder) + n_layers * 0.27 MFLOP
// + 2*H*d_out (decoder), 1.0 MFLOP at the serving width; at B=8, L=3751
// that is 30 GFLOP, 0.45 ms at 67 TFLOP/s f32, against 62 MB of input and
// mask traffic (0.018 ms at 3.35 TB/s); the int-dot modes count their dots
// as int8 operations (engine_layer.cu). All int8 weights together are
// 0.5 MB, more than one SM's shared memory, so they stream from L2. This
// simple design fills B of the 132 SMs.

#include "engine_body.cuh"

namespace {

using namespace engine;

constexpr int kMaxLayers = 8;

struct NetArgs {
  const void* x;         // (B, L, d_in) f32 / bf16
  void* out;             // (B, L, d_out) f32 / bf16
  LayerParams layers[kMaxLayers];
  DenseW enc, dec;
  Mode mode;
  int n_layers, p_max;
  int in_type, out_type;
  int d_in, d_out;
  int L, block_t;
  int ldq;               // bytes a row of the code tile Q (0: no int dot)
};

static_assert(sizeof(NetArgs) <= 4096, "kernel parameters above 4 KB");

__global__ void __launch_bounds__(kThreads)
engine_network_kernel(const __grid_constant__ NetArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = a.mode.h, L = a.L;
  const int ldh = round4(H), ldp = round4(2 * a.p_max);
  const int ldx = round4(a.d_in);
  float* R = smem;
  float* Z = R + kT * ldh;
  float* Y = Z + kT * ldh;
  float* S = Y + kT * ldh;
  float* X = S + kT * ldp;
  float* carry = X + kT * ldx;     // n_layers x (2 * p_max)
  int8_t* Q = reinterpret_cast<int8_t*>(carry + a.n_layers * 2 * a.p_max);

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * L;
  for (int i = tid; i < a.n_layers * 2 * a.p_max; i += blockDim.x)
    carry[i] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kT) {
    const int rows = min(kT, L - t0);
    load_tile(X, ldx, a.x, a.in_type, row0 + t0, a.d_in, rows, 1.f);
    __syncthreads();
    encode_tile(X, ldx, a.enc, a.d_in, a.mode, R, ldh, rows, Q, a.ldq);
    __syncthreads();
    for (int l = 0; l < a.n_layers; ++l) {
      const LayerParams& lp = a.layers[l];
      layer_tile(lp, a.mode, R, Z, Y, S, carry + l * 2 * a.p_max, ldh, ldp,
                 rows, t0, L, a.block_t, Q, a.ldq);
      for (int i = tid; i < rows * H; i += blockDim.x) {
        float* v = R + (i / H) * ldh + i % H;
        *v = stream_value(*v, lp, a.mode.act_bf16);
      }
      __syncthreads();
    }
    decode_tile(R, ldh, a.dec, H, a.d_out, a.out, a.out_type, row0 + t0,
                rows, Q, a.ldq);
    __syncthreads();
  }
}

}  // namespace

// x: (B, L, d_in) of in_type (f32 / bf16); out: (B, L, d_out) of out_type.
// layers: n_layers (<= 8) host structs. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for too many layers.
extern "C" int engine_network_fwd(
    const void* x, void* out, int in_type, int out_type,
    const engine::LayerParams* layers, int n_layers,
    const engine::Mode* mode, const engine::DenseW* enc, int d_in,
    const engine::DenseW* dec, int d_out, int B, int L, int block_t,
    void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  NetArgs a;
  a.x = x;
  a.out = out;
  const int H = mode->h;
  int p_max = 0, q_w = enc->in_mode ? d_in : 0;
  if (dec->in_mode) q_w = engine::imax(q_w, H);
  for (int l = 0; l < n_layers; ++l) {
    a.layers[l] = layers[l];
    p_max = layers[l].p > p_max ? layers[l].p : p_max;
    q_w = engine::imax(q_w, engine::code_width(layers[l], H));
  }
  a.ldq = engine::round4(q_w);
  for (int l = n_layers; l < kMaxLayers; ++l) a.layers[l] = layers[0];
  a.enc = *enc;
  a.dec = *dec;
  a.mode = *mode;
  a.n_layers = n_layers;
  a.p_max = p_max;
  a.in_type = in_type;
  a.out_type = out_type;
  a.d_in = d_in;
  a.d_out = d_out;
  a.L = L;
  a.block_t = block_t;
  const size_t smem =
      sizeof(float) * ((size_t)engine::kT *
                           (3 * engine::round4(H) +
                            engine::round4(2 * p_max) + engine::round4(d_in)) +
                       (size_t)n_layers * 2 * p_max) +
      2 * (size_t)engine::kT * a.ldq;
  cudaError_t err = cudaFuncSetAttribute(
      engine_network_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  engine_network_kernel<<<B, engine::kThreads, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
