// Shared device code of the QAT scan kernels (qat_scan.cu): the diagonal
// complex scan with in-scan activation fake-quant, over time blocks of t
// rows held in a device-memory scratch of (B, L_pad, 2P) floats, row-major
// with the P real parts of a row before its P imaginary parts.
//
// The numerics are the TPU kernel's (sparsernns_tpu/ops/pallas/
// scan_kernel.py `scan_block_body` with `qat_bits`): per block, doubling
// passes whose shifted operand is fake-quantized on the absmax of the whole
// shifted block, then the carry fold with the fake-quantized carry, then
// the fake-quant of the folded block. Every product and sum is rounded on
// its own (__fmul_rn / __fadd_rn / __fsub_rn), in the order of the plain
// version, and every scale divides (IEEE division: the build has no fast
// math): a state near a rounding tie of its grid then takes the plain
// version's code, and a flipped code would be carried into every later
// state of the channel.

#pragma once

#include <cuda_runtime.h>

namespace qat {

// Threads of a CTA of the scan phases (a multiple of 32, at most 1024):
// a pass is latency-bound on the scratch's loads, so many warps.
constexpr int kThreads = 1024;
// Threads of the mixer's phase A, whose B-projection (engine_body.cuh
// `tile_matmul`) needs more registers a thread than 1024 threads leave.
constexpr int kMixThreads = 512;

// The activation grid: qmax = 2^(bits-1) - 1; `on` is 0 at bits >= 32,
// where the fake-quant is the identity.
struct Grid {
  float qmax;
  int on;
};

__host__ inline Grid make_grid(int bits) {
  Grid g;
  g.on = bits < 32;
  g.qmax = g.on ? (float)((1u << (bits - 1)) - 1u) : 1.f;
  return g;
}

__device__ __forceinline__ float scale_of(float amax, const Grid& g) {
  return fmaxf(amax, 1e-20f) / g.qmax;
}

// v on the grid of scale s: round half to even, clip, times s.
__device__ __forceinline__ float on_grid(float v, float s, const Grid& g) {
  if (!g.on) return v;
  return __fmul_rn(fminf(fmaxf(rintf(v / s), -g.qmax - 1.f), g.qmax), s);
}

// Max of (v.x, v.y) over the CTA (blockDim.x a multiple of 32, every
// thread calling); every thread gets the result. The leading barrier also
// orders every earlier write of the CTA before the later reads.
__device__ __forceinline__ float2 cta_max2(float2 v) {
  __shared__ float2 red[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x = fmaxf(v.x, __shfl_xor_sync(0xffffffffu, v.x, o));
    v.y = fmaxf(v.y, __shfl_xor_sync(0xffffffffu, v.y, o));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
    m.x = fmaxf(m.x, red[w].x);
    m.y = fmaxf(m.y, red[w].y);
  }
  return m;
}

// Elements a thread loads before it computes any of them: the loads of a
// pass are independent, and issuing kBatch of them at once hides part of
// the scratch's latency.
constexpr int kBatch = 4;

// One doubling pass over a block: dst_r = src_r + lam^(2^k) * q(src_{r-d})
// for its t rows, with the shifted operand's scales (s_re, s_im). Returns
// this thread's absmax of the new rows [0, next_rows) (the next pass's
// shifted rows). src and dst are the two scratch buffers.
__device__ __forceinline__ float2 one_pass(const float* src, float* dst,
                                           long long blk0, int t, int P,
                                           int d, const float* pw_re,
                                           const float* pw_im, float s_re,
                                           float s_im, const Grid& g,
                                           int next_rows) {
  float2 m = make_float2(0.f, 0.f);
  const int n = t * P;
  const long long shift = (long long)d * 2 * P;
  for (int base = threadIdx.x; base < n; base += kBatch * blockDim.x) {
    float xr[kBatch], xi[kBatch], sr[kBatch], si[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x;
      xr[u] = xi[u] = sr[u] = si[u] = 0.f;
      if (i < n) {
        const int r = i / P, p = i - r * P;
        const long long at = blk0 + (long long)r * 2 * P + p;
        xr[u] = src[at];
        xi[u] = src[at + P];
        if (r >= d) {
          sr[u] = src[at - shift];
          si[u] = src[at - shift + P];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * blockDim.x;
      if (i >= n) break;
      const int r = i / P, p = i - r * P;
      const long long at = blk0 + (long long)r * 2 * P + p;
      const float shr = on_grid(sr[u], s_re, g);
      const float shi = on_grid(si[u], s_im, g);
      const float lr = pw_re[p], li = pw_im[p];
      const float nr = __fadd_rn(
          xr[u], __fsub_rn(__fmul_rn(lr, shr), __fmul_rn(li, shi)));
      const float ni = __fadd_rn(
          xi[u], __fadd_rn(__fmul_rn(lr, shi), __fmul_rn(li, shr)));
      dst[at] = nr;
      dst[at + P] = ni;
      if (r < next_rows) {
        m.x = fmaxf(m.x, fabsf(nr));
        m.y = fmaxf(m.y, fabsf(ni));
      }
    }
  }
  return m;
}

// The block's states after its doubling passes, per (batch row, block).
// On entry `buf0` holds the block (rows [0, t) at `blk0`, row length 2P)
// and `amax` the absmax over its rows [0, t - 1), the first pass's shifted
// rows (as each half's pair). Pass k reads buffer k % 2 and writes buffer
// (k + 1) % 2: x_r += lam^(2^k) * q(x_{r-d}), d = 2^k, the shifted operand
// fake-quantized on the absmax of rows [0, t - d) (or on the global
// absmax `gmax` >= 0). The result is in buffer num_passes % 2.
__device__ inline void doubling_passes(float* buf0, float* buf1,
                                       long long blk0, int t, int P,
                                       const float* __restrict__ pow_re,
                                       const float* __restrict__ pow_im,
                                       int num_passes, const Grid& g,
                                       float gmax, float2 amax) {
  for (int k = 0; k < num_passes; ++k) {
    const int d = 1 << k;
    const float s_re = scale_of(gmax >= 0.f ? gmax : amax.x, g);
    const float s_im = scale_of(gmax >= 0.f ? gmax : amax.y, g);
    // t - 2d: the next pass's shifted rows
    const float2 m = one_pass((k & 1) ? buf1 : buf0, (k & 1) ? buf0 : buf1,
                              blk0, t, P, d, pow_re + k * P, pow_im + k * P,
                              s_re, s_im, g, t - 2 * d);
    amax = cta_max2(m);   // also the barrier between passes
  }
}

// The carry walk of one batch row (one CTA): block by block in order, the
// carry (zero into block 0) fake-quantized on the absmax over its P
// channels, folded into every row r with the lam^(r+1) table `ct`, the
// folded block fake-quantized on its own absmax, its last row the carry
// onward. `x` holds the row's L_pad rows of 2P after the passes; the
// quantized states go to `write(row, p, re, im)`. `sm`: 4P floats of
// shared memory.
template <class Write>
__device__ inline void carry_walk(const float* x, int n_blocks, int t, int P,
                                  const float* __restrict__ ct_re,
                                  const float* __restrict__ ct_im,
                                  const Grid& g, float gmax, float* sm,
                                  Write write) {
  float* c_re = sm;
  float* c_im = sm + P;
  float* q_re = sm + 2 * P;
  float* q_im = sm + 3 * P;
  for (int p = threadIdx.x; p < P; p += blockDim.x) c_re[p] = c_im[p] = 0.f;
  __syncthreads();
  const int n = t * P;
  for (int j = 0; j < n_blocks; ++j) {
    float2 m = make_float2(0.f, 0.f);
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      m.x = fmaxf(m.x, fabsf(c_re[p]));
      m.y = fmaxf(m.y, fabsf(c_im[p]));
    }
    m = cta_max2(m);
    const float sc_re = scale_of(gmax >= 0.f ? gmax : m.x, g);
    const float sc_im = scale_of(gmax >= 0.f ? gmax : m.y, g);
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      q_re[p] = on_grid(c_re[p], sc_re, g);
      q_im[p] = on_grid(c_im[p], sc_im, g);
    }
    __syncthreads();
    const float* blk = x + (long long)j * t * 2 * P;
    // the folded values of kBatch elements from `base` on (loads first)
    auto folded = [&](int base, float* vr, float* vi) {
      float xr[kBatch], xi[kBatch], tr[kBatch], ti[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        xr[u] = xi[u] = tr[u] = ti[u] = 0.f;
        if (i < n) {
          const int r = i / P, p = i - r * P;
          const float* at = blk + (long long)r * 2 * P + p;
          xr[u] = at[0];
          xi[u] = at[P];
          tr[u] = ct_re[i];
          ti[u] = ct_im[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = (base + u * blockDim.x) % P;
        vr[u] = __fadd_rn(xr[u], __fsub_rn(__fmul_rn(tr[u], q_re[p]),
                                           __fmul_rn(ti[u], q_im[p])));
        vi[u] = __fadd_rn(xi[u], __fadd_rn(__fmul_rn(tr[u], q_im[p]),
                                           __fmul_rn(ti[u], q_re[p])));
      }
    };
    m = make_float2(0.f, 0.f);
    for (int base = threadIdx.x; base < n; base += kBatch * blockDim.x) {
      float vr[kBatch], vi[kBatch];
      folded(base, vr, vi);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (base + u * (int)blockDim.x >= n) break;
        m.x = fmaxf(m.x, fabsf(vr[u]));
        m.y = fmaxf(m.y, fabsf(vi[u]));
      }
    }
    m = cta_max2(m);
    const float so_re = scale_of(gmax >= 0.f ? gmax : m.x, g);
    const float so_im = scale_of(gmax >= 0.f ? gmax : m.y, g);
    for (int base = threadIdx.x; base < n; base += kBatch * blockDim.x) {
      float vr[kBatch], vi[kBatch];
      folded(base, vr, vi);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * blockDim.x;
        if (i >= n) break;
        const float qr = on_grid(vr[u], so_re, g);
        const float qi = on_grid(vi[u], so_im, g);
        const int r = i / P, p = i - r * P;
        if (r == t - 1) {
          c_re[p] = qr;
          c_im[p] = qi;
        }
        write(j * t + r, p, qr, qi);
      }
    }
    __syncthreads();   // the new carry and every write before the next block
  }
}

}  // namespace qat
