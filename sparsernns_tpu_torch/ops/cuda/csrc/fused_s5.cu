// The S5 mixer in one kernel, float mode, one CTA per batch row:
//
//   bu = u @ W_b                          (H -> [re | im] of P channels)
//   xs = scan(lam, bu)                    (complex diagonal recurrence)
//   y = [xs_re xs_im] @ W_c + D * u       (relu on xs if relu_state)
//
// Only u is read and only y written: the states never reach device memory.
// Replaces the TPU kernel sparsernns_tpu/ops/pallas/fused_s5.py
// `fused_s5_apply` (pallas_call at :258, body `_fused_kernel` :37) with f32
// weights and an f32 input. The chain is a strict subset of the whole-layer
// tail kernel's (layer_tail.cu), so it is built from the same device
// functions (layer_tail_body.cuh: `tile_matmul`, `scan_tile` over
// scan_step.cuh). The TPU kernel scans a time block by doubling with tables
// of powers of lam and pads to (8, 128) tiles; here a thread walks its
// channel in order over a 32-row tile, which needs no table and no padding,
// so the time block is not numerics.
//
// On the TPU the grid walks the time blocks of a batch row in order with the
// carry in VMEM scratch. CUDA blocks run in no order, so one CTA owns one
// batch row and loops over the tiles itself, the carry in shared memory. Per
// tile the input rows and the states live in shared memory (kT*(H + 2P)
// floats, 57 KB at H=192, P=128); W_b and W_c (H*2P floats each, 0.39 MB
// together) are streamed from L2 by every product, coalesced along the
// output column, each thread keeping kRT rows of accumulators. Plain f32 FMA
// on the CUDA cores, no tensor cores: the mixer is held to f32 accuracy.
//
// Bound: operations. Per row 2*H*2P (B-projection) + 2*2P*H (C-projection)
// = 196,608 flop at H=192, P=128; at B=8, L=3751 that is 5.9 GFLOP, 0.088 ms
// at the card's 67 TFLOP/s f32 peak, against 46 MB of device memory traffic
// (u read, y written, weights), 0.014 ms at 3.35 TB/s.
//
// Limits of this simple design, as for the tail kernel: B CTAs in all fill
// B of the 132 SMs, and within an SM the products are bound by
// shared-memory reads and L2 weight streaming.

#include "layer_tail_body.cuh"

namespace {

using namespace tail;

__global__ void __launch_bounds__(kThreads)
fused_s5_kernel(const float* __restrict__ u, float* __restrict__ y,
                const float* __restrict__ wb, const float* __restrict__ wc,
                const float* __restrict__ dvec,
                const float* __restrict__ lam_re,
                const float* __restrict__ lam_im, int L, int H, int P,
                int relu_state) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldh = round4(H);
  const int ldp = round4(2 * P);
  float* U = smem;                 // input rows
  float* S = U + kT * ldh;         // bu, then the states [re | im]
  float* carry = S + kT * ldp;     // (2P) carry [re | im] across tiles

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* ub = u + (long long)b * L * H;
  float* yb = y + (long long)b * L * H;

  for (int p = tid; p < 2 * P; p += blockDim.x) carry[p] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kT) {
    const int rows = min(kT, L - t0);
    // ---- load the tile; rows past the end are zero ----
    for (int i = tid; i < kT * H; i += blockDim.x) {
      const int r = i / H, c = i % H;
      U[r * ldh + c] = r < rows ? ub[(long long)(t0 + r) * H + c] : 0.f;
    }
    __syncthreads();
    // ---- B-projection: S = U @ W_b ----
    tile_matmul(U, ldh, wb, H, 2 * P, rows,
                [&](int r, int c, float acc) { S[r * ldp + c] = acc; });
    __syncthreads();
    // ---- in-order scan over the tile, carry in shared memory ----
    scan_tile(S, ldp, P, rows, lam_re, lam_im, carry, relu_state != 0,
              nullptr);
    __syncthreads();
    // ---- C-projection + D * u, straight to device memory ----
    tile_matmul(S, ldp, wc, 2 * P, H, rows, [&](int r, int c, float acc) {
      yb[(long long)(t0 + r) * H + c] = fmaf(dvec[c], U[r * ldh + c], acc);
    });
    __syncthreads();
  }
}

}  // namespace

// u, y: (B, L, H) contiguous. wb: (H, 2P); wc: (2P, H), conj-sym factor
// folded in; d: (H). lam_re, lam_im: (P). Returns cudaGetLastError() after
// the launch.
extern "C" int fused_s5_fwd(
    const float* u, float* y, const float* wb, const float* wc,
    const float* d, const float* lam_re, const float* lam_im, int B, int L,
    int H, int P, int relu_state, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kT * (round4(H) + round4(2 * P)) + 2 * P);
  cudaError_t err = cudaFuncSetAttribute(
      fused_s5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_s5_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      u, y, wb, wc, d, lam_re, lam_im, L, H, P, relu_state);
  return (int)cudaGetLastError();
}
