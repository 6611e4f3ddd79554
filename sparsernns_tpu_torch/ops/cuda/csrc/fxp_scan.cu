// The fixed-point engine's integer recurrence (ops/cuda/fxp_scan.py): per
// (batch row, state channel), from a zero state,
//
//   acc_re = ((a_re * x_re) >> s_re) - ((a_im * x_im) >> s_im) + (bu_re << g)
//   acc_im = ((a_re * x_im) >> s_re) + ((a_im * x_re) >> s_im) + (bu_im << g)
//   x = clip(round_half_even(acc >> g), lo, hi)
//
// in int32 two's complement with XLA's wrap. Replaces no TPU kernel: the
// JAX package runs it as jax.lax.scan over `step` in
// sparsernns_tpu/fxp/model.py:362-378 (no pallas_call).
//
// One thread owns one (batch row, channel) pair, re and im together, and
// walks t = 0 .. L-1; one-warp CTAs, a grid of (ceil(P / 32), B). The
// arithmetic runs on uint32_t, whose wrap is defined, so nvcc never sees a
// signed overflow; right shifts are arithmetic on int32_t. The loads of
// bu do not depend on the state, so each thread loads the next kAhead
// steps into registers while it walks the current kAhead; a warp's loads
// and stores cover 128 consecutive bytes.
//
// Bound: bytes. 16 bytes per (b, t, p) in and out (bu re / im in, x re /
// im out): 61.5 MB at B = 8, L = 3751, P = 128, 0.018 ms at 3.35 TB/s.
// The kernel is latency-bound instead: L dependent steps of about a dozen
// integer operations each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kAhead = 8;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

// s in [0, 32): checked by the wrapper
__device__ __forceinline__ int32_t wrap_shl(int32_t a, int s) {
  return (int32_t)((uint32_t)a << s);
}

// fxp_rshift_round(x, s, ROUND): round half to even, s in [0, 32)
__device__ __forceinline__ int32_t rshift_round_even(int32_t x, int s) {
  if (s == 0) return x;
  const int32_t half = (int32_t)(1u << (s - 1));
  const int32_t q = wrap_add(x, half) >> s;
  const int32_t mask = (int32_t)((1u << s) - 1u);
  return (x & mask) == half ? wrap_sub(q, q & 1) : q;
}

__device__ __forceinline__ int32_t clip(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct Args {
  int B, L, P, s_re, s_im, g, lo_re, hi_re, lo_im, hi_im;
};

__global__ void __launch_bounds__(kWarp)
fxp_scan_kernel(const int32_t* __restrict__ bu_re,
                const int32_t* __restrict__ bu_im,
                const int32_t* __restrict__ a_re,
                const int32_t* __restrict__ a_im,
                int32_t* __restrict__ xs_re, int32_t* __restrict__ xs_im,
                Args args) {
  const int p = blockIdx.x * kWarp + threadIdx.x;
  if (p >= args.P) return;
  const int32_t ar = a_re[p], ai = a_im[p];
  const size_t row = (size_t)blockIdx.y * args.L * args.P + p;
  const int s_re = args.s_re, s_im = args.s_im, g = args.g;
  int32_t xr = 0, xi = 0;
  // bu of the next kAhead steps is loaded while this block of steps runs
  int32_t br[kAhead], bi[kAhead], nr[kAhead], ni[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const bool in = j < args.L;
    br[j] = in ? __ldg(bu_re + row + (size_t)j * args.P) : 0;
    bi[j] = in ? __ldg(bu_im + row + (size_t)j * args.P) : 0;
  }
  for (int t0 = 0; t0 < args.L; t0 += kAhead) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int t = t0 + kAhead + j;
      const size_t off = row + (size_t)t * args.P;
      nr[j] = t < args.L ? __ldg(bu_re + off) : 0;
      ni[j] = t < args.L ? __ldg(bu_im + off) : 0;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t0 + j >= args.L) break;
      const int32_t prr = wrap_mul(ar, xr) >> s_re;
      const int32_t pii = wrap_mul(ai, xi) >> s_im;
      const int32_t pri = wrap_mul(ar, xi) >> s_re;
      const int32_t pir = wrap_mul(ai, xr) >> s_im;
      const int32_t acc_r = wrap_add(wrap_sub(prr, pii), wrap_shl(br[j], g));
      const int32_t acc_i = wrap_add(wrap_add(pri, pir), wrap_shl(bi[j], g));
      xr = clip(rshift_round_even(acc_r, g), args.lo_re, args.hi_re);
      xi = clip(rshift_round_even(acc_i, g), args.lo_im, args.hi_im);
      const size_t off = row + (size_t)(t0 + j) * args.P;
      xs_re[off] = xr;
      xs_im[off] = xi;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      br[j] = nr[j];
      bi[j] = ni[j];
    }
  }
}

}  // namespace

// bu_re, bu_im, xs_re, xs_im: (B, L, P) int32; a_re, a_im: (P,) int32.
// Returns the launch's error, or 0.
extern "C" int fxp_scan_fwd(const int32_t* bu_re, const int32_t* bu_im,
                            const int32_t* a_re, const int32_t* a_im,
                            int32_t* xs_re, int32_t* xs_im, int B, int L,
                            int P, int s_re, int s_im, int g, int lo_re,
                            int hi_re, int lo_im, int hi_im, void* stream) {
  if (B <= 0 || L <= 0 || P <= 0) return 0;
  const Args args = {B, L, P, s_re, s_im, g, lo_re, hi_re, lo_im, hi_im};
  const dim3 grid((P + kWarp - 1) / kWarp, B);
  fxp_scan_kernel<<<grid, kWarp, 0, (cudaStream_t)stream>>>(
      bu_re, bu_im, a_re, a_im, xs_re, xs_im, args);
  return (int)cudaGetLastError();
}
