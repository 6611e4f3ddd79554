// Diagonal complex linear recurrence over time, in either direction:
//   forward  x_t = lam * x_{t-1} + bu_t, with an optional initial carry
//            (streaming);
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

// Step s of the walk visits time row s (forward) or L - 1 - s (reverse).
template <bool kReverse>
__global__ void diag_scan_kernel(
    const float* __restrict__ bu_re, const float* __restrict__ bu_im,
    long long stride_b, long long stride_t,
    const float* __restrict__ lam_re, const float* __restrict__ lam_im,
    const float* __restrict__ c_re, const float* __restrict__ c_im,
    float* __restrict__ out_re, float* __restrict__ out_im,
    int B, int L, int P) {
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
      scan::scan_step(lr, li, ur[k], ui[k], xr, xi);
      o_r[t * P] = xr;
      o_i[t * P] = xi;
    }
  }
  for (; s < L; ++s) {
    const long long t = kReverse ? L - 1 - s : s;
    scan::scan_step(lr, li, in_r[t * stride_t], in_i[t * stride_t], xr, xi);
    o_r[t * P] = xr;
    o_i[t * P] = xi;
  }
}

}  // namespace

// bu_re/bu_im: (B, L, P) views with element strides (stride_b, stride_t, 1)
// -- they may be the two halves of one (B, L, 2P) tensor. c_re/c_im:
// (B, P) contiguous, or null for a zero initial state (the reverse direction
// takes no carry: the caller passes null). out_re/out_im: (B, L, P)
// contiguous. reverse: 0 forward in time, 1 backward. Returns
// cudaGetLastError() after the launch.
extern "C" int diag_scan_run(
    const float* bu_re, const float* bu_im, long long stride_b,
    long long stride_t, const float* lam_re, const float* lam_im,
    const float* c_re, const float* c_im, float* out_re, float* out_im,
    int B, int L, int P, int reverse, void* stream) {
  dim3 grid((P + kThreads - 1) / kThreads, B);
  if (reverse) {
    diag_scan_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        bu_re, bu_im, stride_b, stride_t, lam_re, lam_im, c_re, c_im, out_re,
        out_im, B, L, P);
  } else {
    diag_scan_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        bu_re, bu_im, stride_b, stride_t, lam_re, lam_im, c_re, c_im, out_re,
        out_im, B, L, P);
  }
  return (int)cudaGetLastError();
}
