// Diagonal complex linear recurrence over time, in either direction:
//   forward  x_t = lam * x_{t-1} + bu_t, with an optional initial carry
//            (streaming), and optionally with the serving engine's block
//            requant: every state is written on a frozen grid
//            (s_re, s_im, 2^(bits-1) codes; round half to even, then clip)
//            and, at the end of each block of `block_t` steps, the
//            running f32 state is replaced by its grid value, so the carry
//            into the next block is the requantized last state;
//   reverse  x_t = lam * x_{t+1} + bu_t, from a zero state past the end (the
//            backward half of a bidirectional mixer, and the adjoint of the
//            forward scan when called with conj(lam)).
//
// Replaces the TPU kernel sparsernns_tpu/ops/pallas/scan_kernel.py
// `pallas_diag_scan` -> `_pallas_diag_scan` (pallas_call at :494). On the
// TPU the grid walks time blocks in order and keeps the carry in VMEM
// scratch, and the reverse direction flips its input and its output; CUDA
// blocks run in no order, so here one thread owns one (batch row, channel)
// pair and loops over all of time itself, the carry in registers, and the
// reverse direction walks the same arrays from the last step down: no
// flipped copy is made.
//
// Bound: bytes. Read bu_re and bu_im once (2*B*L*P*4 bytes) and write
// x_re and x_im once (the same again); 8 flops per element are nothing
// against that. At the serving shape B=8, L=3751, P=128 that is 61 MB.
//
// The block requant (`pallas_diag_scan(block_requant=...)`, applied there
// per doubling block after the carry fold) costs one division, one rint
// and one clip per element and step; it changes no byte count. A block is
// numerics here, not a tile: the walk stays one thread per channel. That
// mode steps without contraction (scan_step_rn), as the serving engine's
// other kernels and the plain recurrence do, so that a state near a tie of
// the grid takes the plain version's code (see scan_step.cuh).
//
// Limits of this simple design: B*P threads in all (1024 at B=8) fill a
// few of the 132 SMs, and each thread walks L steps in order, so the
// kernel is latency-bound, not bandwidth-bound. Loads are coalesced along
// P and issued UNROLL steps ahead of the dependent multiply-adds to hide
// part of the memory latency. A chunked two-pass scan (chunk-local scans
// in parallel, then a carry pass) is the way to the bandwidth bound.

#include <cuda_runtime.h>

#include "scan_step.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

// The frozen grid of the block requant (forward direction only).
struct Requant {
  float s_re, s_im, qmin, qmax;
  int block_t;
};

__device__ __forceinline__ float grid_value(float v, float s, float qmin,
                                            float qmax) {
  return __fmul_rn(fminf(fmaxf(rintf(v / s), qmin), qmax), s);
}

// One step to time row t: the state advances, (wr, wi) is what to write,
// and at a block end the running state is put on the grid.
template <bool kRequant>
__device__ __forceinline__ void advance(const Requant& rq, float lr, float li,
                                        float bu_r, float bu_i, long long t,
                                        int L, float& xr, float& xi,
                                        float& wr, float& wi) {
  if (!kRequant) {
    scan::scan_step(lr, li, bu_r, bu_i, xr, xi);
    wr = xr;
    wi = xi;
    return;
  }
  scan::scan_step_rn(lr, li, bu_r, bu_i, xr, xi);
  wr = grid_value(xr, rq.s_re, rq.qmin, rq.qmax);
  wi = grid_value(xi, rq.s_im, rq.qmin, rq.qmax);
  const int next = (int)t + 1;
  if (next % rq.block_t == 0 || next == L) {
    xr = wr;
    xi = wi;
  }
}

// Step s of the walk visits time row s (forward) or L - 1 - s (reverse).
template <bool kReverse, bool kRequant>
__global__ void diag_scan_kernel(
    const float* __restrict__ bu_re, const float* __restrict__ bu_im,
    long long stride_b, long long stride_t,
    const float* __restrict__ lam_re, const float* __restrict__ lam_im,
    const float* __restrict__ c_re, const float* __restrict__ c_im,
    float* __restrict__ out_re, float* __restrict__ out_im,
    int B, int L, int P, Requant rq) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (p >= P || b >= B) return;
  const float lr = lam_re[p];
  const float li = lam_im[p];
  float xr = 0.f, xi = 0.f;
  if (c_re != nullptr) {
    xr = c_re[(long long)b * P + p];
    xi = c_im[(long long)b * P + p];
  }
  const float* in_r = bu_re + b * stride_b + p;
  const float* in_i = bu_im + b * stride_b + p;
  float* o_r = out_re + (long long)b * L * P + p;
  float* o_i = out_im + (long long)b * L * P + p;
  int s = 0;
  for (; s + kUnroll <= L; s += kUnroll) {
    float ur[kUnroll], ui[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long t = kReverse ? L - 1 - (s + k) : s + k;
      ur[k] = in_r[t * stride_t];
      ui[k] = in_i[t * stride_t];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long t = kReverse ? L - 1 - (s + k) : s + k;
      float wr, wi;
      advance<kRequant>(rq, lr, li, ur[k], ui[k], t, L, xr, xi, wr, wi);
      o_r[t * P] = wr;
      o_i[t * P] = wi;
    }
  }
  for (; s < L; ++s) {
    const long long t = kReverse ? L - 1 - s : s;
    float wr, wi;
    advance<kRequant>(rq, lr, li, in_r[t * stride_t], in_i[t * stride_t], t,
                      L, xr, xi, wr, wi);
    o_r[t * P] = wr;
    o_i[t * P] = wi;
  }
}

}  // namespace

// bu_re/bu_im: (B, L, P) views with element strides (stride_b, stride_t, 1)
// -- they may be the two halves of one (B, L, 2P) tensor. c_re/c_im:
// (B, P) contiguous, or null for a zero initial state (the reverse direction
// takes no carry: the caller passes null). out_re/out_im: (B, L, P)
// contiguous. reverse: 0 forward in time, 1 backward. block_t > 0 turns
// on the block requant onto (s_re, s_im) with codes in [qmin, qmax]
// (forward only: the caller refuses it with reverse). Returns
// cudaGetLastError() after the launch.
extern "C" int diag_scan_run(
    const float* bu_re, const float* bu_im, long long stride_b,
    long long stride_t, const float* lam_re, const float* lam_im,
    const float* c_re, const float* c_im, float* out_re, float* out_im,
    int B, int L, int P, int reverse, int block_t, float s_re, float s_im,
    float qmin, float qmax, void* stream) {
  dim3 grid((P + kThreads - 1) / kThreads, B);
  const Requant rq{s_re, s_im, qmin, qmax, block_t};
  cudaStream_t st = (cudaStream_t)stream;
  if (reverse) {
    diag_scan_kernel<true, false><<<grid, kThreads, 0, st>>>(
        bu_re, bu_im, stride_b, stride_t, lam_re, lam_im, c_re, c_im, out_re,
        out_im, B, L, P, rq);
  } else if (block_t > 0) {
    diag_scan_kernel<false, true><<<grid, kThreads, 0, st>>>(
        bu_re, bu_im, stride_b, stride_t, lam_re, lam_im, c_re, c_im, out_re,
        out_im, B, L, P, rq);
  } else {
    diag_scan_kernel<false, false><<<grid, kThreads, 0, st>>>(
        bu_re, bu_im, stride_b, stride_t, lam_re, lam_im, c_re, c_im, out_re,
        out_im, B, L, P, rq);
  }
  return (int)cudaGetLastError();
}
