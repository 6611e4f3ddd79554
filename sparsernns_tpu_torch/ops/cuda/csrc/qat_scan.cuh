// Device code of the QAT scan kernels (qat_scan.cu): the λ tables kernel
// and the diagonal complex scan with in-scan activation fake-quant, one
// thread-block cluster per (batch row, time block of t rows), the block
// held in the clusters' shared memory, split by state channel.
//
// The numerics are the TPU kernel's (sparsernns_tpu/ops/pallas/
// scan_kernel.py `scan_block_body` with `qat_bits`): per block, doubling
// passes whose shifted operand is fake-quantized on the absmax of the whole
// shifted block, then the carry fold with the fake-quantized carry, then
// the fake-quant of the folded block (and, with a block requant, every
// state on the frozen grid). Every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn), in the order of the plain version,
// and every scale divides (IEEE division: the build has no fast math): a
// state near a rounding tie of its grid then takes the plain version's
// code, and a flipped code would be carried into every later state of the
// channel. Maxima are exact in any order, so splitting a block by channel
// and combining the CTAs' partial maxima changes no value.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace qat {

namespace cg = cooperative_groups;

// Threads of a scan CTA. A CTA's channel slice (cpc channels, a power of
// two up to 256) divides it, so a thread keeps one channel in every chunk.
constexpr int kThreads = 512;
// Elements a thread reads into registers before a chunk's barrier.
constexpr int kElems = 4;
// Threads of a CTA of the tables kernel.
constexpr int kTableThreads = 1024;
// Largest cluster: 8 is portable, 16 needs the non-portable attribute.
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;

// The activation grid: qmax = 2^(bits-1) - 1; `on` is 0 at bits >= 32 (or
// no bits), where the fake-quant is the identity.
struct Grid {
  float qmax;
  int on;
};

__host__ inline Grid make_grid(int bits) {
  Grid g;
  g.on = bits > 0 && bits < 32;
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

// The frozen grid of a block requant (s_re, s_im, bits): `on` 0 for none.
struct Requant {
  float s_re, s_im, qmin, qmax;
  int on;
};

__host__ inline Requant make_requant(float s_re, float s_im, int bits) {
  Requant q = {};
  q.on = bits > 0;
  if (q.on) {
    q.s_re = s_re;
    q.s_im = s_im;
    q.qmax = (float)((1ull << (bits - 1)) - 1ull);
    q.qmin = -q.qmax - 1.f;
  }
  return q;
}

__device__ __forceinline__ float requant(float v, float s, const Requant& q) {
  if (!q.on) return v;
  return __fmul_rn(fminf(fmaxf(rintf(v / s), q.qmin), q.qmax), s);
}

// Max of (v.x, v.y) over the 32 lanes of a warp.
__device__ __forceinline__ float2 warp_max2(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x = fmaxf(v.x, __shfl_xor_sync(0xffffffffu, v.x, o));
    v.y = fmaxf(v.y, __shfl_xor_sync(0xffffffffu, v.y, o));
  }
  return v;
}

// Max of (v.x, v.y) over the CTA (blockDim.x a multiple of 32, every
// thread calling); every thread gets the result. The leading barrier also
// orders every earlier write of the CTA before the later reads.
__device__ __forceinline__ float2 cta_max2(float2 v) {
  __shared__ float2 red[32];
  v = warp_max2(v);
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

// Max of (v.x, v.y) over the whole cluster. Each CTA publishes its
// partial in its own shared memory (`pub[slot]`); after cluster.sync()
// warp 0 of every CTA reads the partials of all ranks through distributed
// shared memory. Successive calls alternate `slot`, so one cluster barrier
// a call keeps a partial from being overwritten before every rank read it.
__device__ inline float2 cluster_max2(float2 v, int slot, float2* pub,
                                      float2* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const float2 m = cta_max2(v);
  if (threadIdx.x == 0) pub[slot] = m;
  cluster.sync();
  if (threadIdx.x < 32) {
    float2 r = make_float2(0.f, 0.f);
    if (threadIdx.x < cluster.num_blocks())
      r = *cluster.map_shared_rank(pub + slot, threadIdx.x);
    r = warp_max2(r);
    if (threadIdx.x == 0) out[slot] = r;
  }
  __syncthreads();
  return out[slot];
}

// Wait until *count reaches n (the CTAs of the cluster before that
// published a carry). A wait that outlasts any run of the kernel (about
// 4 s) traps: the launch then fails with an error instead of hanging.
__device__ inline void wait_count(int* count, int n) {
  unsigned ns = 32;
  long long spins = 0;
  while (atomicAdd(count, 0) < n) {
    __nanosleep(ns);
    if (ns < 1024) ns *= 2;
    if (++spins > (1ll << 22)) __trap();
  }
  __threadfence();
}

// ---------------------------------------------------------------- tables

struct TableArgs {
  const float* lam_re;   // (P)
  const float* lam_im;
  float* pow_re;         // (num_passes, P): lam^(2^k), each level on a_bits
  float* pow_im;
  float* ct_re;          // (t, P): lam^(r+1), the whole table on a_bits
  float* ct_im;
  int* sync;             // n_sync ints the scan kernel counts on: zeroed
  int n_sync;
  int P, t, num_passes;
  Grid ga;
};

// One cluster of kTableCluster CTAs. Warp 0 of rank 0 builds the powers
// (each lane its own channels, the absmax over P by shuffles); every rank
// builds t / kTableCluster rows of the carry-fold table, whose absmax the
// cluster combines through distributed shared memory. The order of every
// operation is the plain version's (ops/cuda/qat_scan.py
// lambda_power_tables, ops/scan.py lambda_powers), one op at a time, no
// contraction: sqrt(lr*lr + li*li), atan2, log of the clamped radius,
// exp(t * log r), cos / sin of t * theta, each product rounded on its own,
// so the tables can equal the PyTorch ops' bit for bit.
constexpr int kTableCluster = 8;

__global__ void __cluster_dims__(kTableCluster, 1, 1)
__launch_bounds__(kTableThreads)
qat_tables_kernel(const __grid_constant__ TableArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 tab_smem4[];
  __shared__ float2 pub[2], amax_s[2];
  const int P = a.P, tid = threadIdx.x, nt = blockDim.x;
  const int rank = (int)cluster.block_rank();
  float* lg = reinterpret_cast<float*>(tab_smem4);   // log(max(|lam|, 1e-30))
  float* th = lg + P;                                // atan2(lam_im, lam_re)
  float* cur_re = th + P;                            // rank 0: the powers
  float* cur_im = cur_re + P;
  if (rank == 0)
    for (int i = tid; i < a.n_sync; i += nt) a.sync[i] = 0;
  for (int p = tid; p < P; p += nt) {
    const float lr = a.lam_re[p], li = a.lam_im[p];
    const float r = sqrtf(__fadd_rn(__fmul_rn(lr, lr), __fmul_rn(li, li)));
    lg[p] = logf(fmaxf(r, 1e-30f));
    th[p] = atan2f(li, lr);
  }
  // the powers: level k on its absmax over P, then squared
  if (rank == 0 && tid < 32) {
    for (int p = tid; p < P; p += 32) {
      cur_re[p] = a.lam_re[p];
      cur_im[p] = a.lam_im[p];
    }
    for (int k = 0; k < a.num_passes; ++k) {
      float2 m = make_float2(0.f, 0.f);
      for (int p = tid; p < P; p += 32) {
        m.x = fmaxf(m.x, fabsf(cur_re[p]));
        m.y = fmaxf(m.y, fabsf(cur_im[p]));
      }
      m = warp_max2(m);
      const float s_re = scale_of(m.x, a.ga), s_im = scale_of(m.y, a.ga);
      for (int p = tid; p < P; p += 32) {
        const float qr = on_grid(cur_re[p], s_re, a.ga);
        const float qi = on_grid(cur_im[p], s_im, a.ga);
        a.pow_re[k * P + p] = qr;
        a.pow_im[k * P + p] = qi;
        cur_re[p] = __fsub_rn(__fmul_rn(qr, qr), __fmul_rn(qi, qi));
        cur_im[p] = __fmul_rn(__fmul_rn(2.f, qr), qi);
      }
    }
  }
  __syncthreads();   // lg and th of every channel
  // this rank's rows of the carry-fold table, then the fake-quant of the
  // whole table on its absmax
  const int rows = (a.t + kTableCluster - 1) / kTableCluster;
  const int i0 = min(rank * rows, a.t) * P;
  const int i1 = min((rank + 1) * rows, a.t) * P;
  float2 m = make_float2(0.f, 0.f);
  for (int i = i0 + tid; i < i1; i += nt) {
    const int r = i / P, p = i - r * P;
    const float tt = (float)(r + 1);
    const float rk = expf(__fmul_rn(tt, lg[p]));
    const float ang = __fmul_rn(tt, th[p]);
    const float vr = __fmul_rn(rk, cosf(ang));
    const float vi = __fmul_rn(rk, sinf(ang));
    a.ct_re[i] = vr;
    a.ct_im[i] = vi;
    m.x = fmaxf(m.x, fabsf(vr));
    m.y = fmaxf(m.y, fabsf(vi));
  }
  if (!a.ga.on) return;
  m = cluster_max2(m, 0, pub, amax_s);
  const float s_re = scale_of(m.x, a.ga), s_im = scale_of(m.y, a.ga);
  for (int i = i0 + tid; i < i1; i += nt) {   // the entries this thread wrote
    a.ct_re[i] = on_grid(a.ct_re[i], s_re, a.ga);
    a.ct_im[i] = on_grid(a.ct_im[i], s_im, a.ga);
  }
  cluster.sync();   // no CTA leaves while a rank may still read its partial
}

// ------------------------------------------------------------------ scan

struct ScanArgs {
  // K1: bu halves (B, L, P), element strides (sb, st, 1); lam and the
  // carry in (B, P) (null: none) for x_0 = lam * c + bu_0; the states out
  // (B, L, P) contiguous, unflipped.
  const float* bu_re;
  const float* bu_im;
  long long sb, st;
  const float* lam_re;
  const float* lam_im;
  const float* ci_re;
  const float* ci_im;
  float* out_re;
  float* out_im;
  // K4a: (B * L, ld) f32, bu in ([re | im] in a row's first 2P), the
  // states out in place; null for K1.
  float* io;
  int ld;
  const float* pow_re;   // (num_passes, P)
  const float* pow_im;
  const float* ct_re;    // (t, P)
  const float* ct_im;
  const float* gmax;     // the global state absmax (device scalar) or null
  float* cbuf;           // (B, n_blocks, 2P): each block's carry onward
  int* sync;             // [0]: tickets; [1 + b * n_blocks + j]: CTAs that
                         // published block j's carry (zeroed by the tables
                         // kernel of the same call)
  int B, L, P, t, n_blocks, num_passes, cpc_log2, reverse;
  Grid g;
  Requant rq;
};

// Shared memory of a scan CTA after its block slice (2 t cpc floats): the
// carry in (2P floats) and the carry on its grid (2 cpc).
__host__ __device__ inline size_t scan_smem(int t, int P, int cpc) {
  return sizeof(float) * (2 * (size_t)t * cpc + 2 * (size_t)P + 2 * cpc);
}

// One cluster of n CTAs per (batch row b, time block j); CTA `rank` holds
// channels [rank * cpc, (rank + 1) * cpc) of all t rows of the block (re
// and im) in shared memory, element i = r * cpc + c. Clusters take a ticket
// when they start; ticket -> (j, b) in block-major order, so the cluster of
// block j - 1 of a row started before that of block j and waits on nothing
// later: the look-back below cannot deadlock whatever the residency.
//
//   load    the block's rows (zero past L, the padding rows), each CTA's
//           partial absmax of rows [0, t - 1);
//   passes  k = 0 .. num_passes - 1, d = 2^k: x_r += lam^(2^k) * q(x_{r-d})
//           in place, chunk by chunk from the top rows down (every operand
//           of a chunk read before its barrier, written after it: the rows
//           below, which the shift reads, are still the pass's inputs),
//           each pass's scales from the cluster's absmax of rows
//           [0, t - d) of the pre-pass block (or the global absmax);
//   fold    the carry of block j - 1, published by its cluster (zero for
//           j = 0), fake-quantized on its absmax over P, times lam^(r+1)
//           into every row; the folded block's cluster absmax;
//   out     row t - 1 on its grids first, published as the carry onward
//           (each CTA its channels, then a count), then every state of the
//           block on its grids, stored where row < L.
template <bool kMixer>
__global__ void __launch_bounds__(kThreads)
qat_scan_kernel(const __grid_constant__ ScanArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 scan_smem4[];
  __shared__ float2 pub[2], amax_s[2];
  __shared__ int s_ticket;
  const int tid = threadIdx.x;
  const int P = a.P, t = a.t, nb = a.n_blocks;
  const int cpc = 1 << a.cpc_log2;
  const int N = t * cpc;
  float* xr = reinterpret_cast<float*>(scan_smem4);
  float* xi = xr + N;
  float* cs = xi + N;        // the carry in: P re, then P im
  float* qc = cs + 2 * P;    // the slice's carry on its grid: cpc re, cpc im
  const int rank = (int)cluster.block_rank();
  const int n_cta = (int)cluster.num_blocks();
  const int c0 = rank * cpc;
  // the channel of every element this thread touches in a pass or fold
  const int ct = tid & (cpc - 1);
  const int pt = c0 + ct;
  const bool live = pt < P;

  if (rank == 0 && tid == 0) s_ticket = atomicAdd(a.sync, 1);
  cluster.sync();
  const int ticket = *cluster.map_shared_rank(&s_ticket, 0);
  const int j = ticket / a.B, b = ticket - j * a.B;
  const bool global = a.gmax != nullptr;
  const float gmax = global ? *a.gmax : 0.f;
  const Grid g = a.g;
  // a cluster maximum only where a per-block scale needs it
  const bool reduce = g.on && !global;
  int slot = 0;
  auto block_max = [&](float2 m) {
    if (!reduce) {
      __syncthreads();
      return m;
    }
    const float2 r = cluster_max2(m, slot, pub, amax_s);
    slot ^= 1;
    return r;
  };

  // ---- load ----
  float2 m = make_float2(0.f, 0.f);
  for (int i = tid; i < N; i += kThreads) {
    const int r = i >> a.cpc_log2;
    const int row = j * t + r;
    float vr = 0.f, vi = 0.f;
    if (row < a.L && live) {
      if (kMixer) {
        const float* s = a.io + ((long long)b * a.L + row) * a.ld + pt;
        vr = s[0];
        vi = s[P];
      } else {
        const long long tau = a.reverse ? a.L - 1 - row : row;
        const long long at = b * a.sb + tau * a.st + pt;
        vr = a.bu_re[at];
        vi = a.bu_im[at];
        if (a.ci_re != nullptr && tau == 0) {   // x_0 = lam * c + bu_0
          const float lr = a.lam_re[pt], li = a.lam_im[pt];
          const float cr = a.ci_re[(long long)b * P + pt];
          const float ci = a.ci_im[(long long)b * P + pt];
          vr = __fadd_rn(vr, __fsub_rn(__fmul_rn(lr, cr), __fmul_rn(li, ci)));
          vi = __fadd_rn(vi, __fadd_rn(__fmul_rn(lr, ci), __fmul_rn(li, cr)));
        }
      }
    }
    xr[i] = vr;
    xi[i] = vi;
    if (r < t - 1) {
      m.x = fmaxf(m.x, fabsf(vr));
      m.y = fmaxf(m.y, fabsf(vi));
    }
  }
  float2 amax = block_max(m);

  // ---- doubling passes ----
  constexpr int kChunk = kThreads * kElems;
  for (int k = 0; k < a.num_passes; ++k) {
    const int d = 1 << k;
    const float s_re = scale_of(global ? gmax : amax.x, g);
    const float s_im = scale_of(global ? gmax : amax.y, g);
    const float lr = live ? a.pow_re[k * P + pt] : 0.f;
    const float li = live ? a.pow_im[k * P + pt] : 0.f;
    const int shift = d << a.cpc_log2;
    const int lim = (t - 2 * d) << a.cpc_log2;   // the next pass's rows
    m = make_float2(0.f, 0.f);
    for (int base = (N - 1) / kChunk * kChunk; base >= 0; base -= kChunk) {
      float vr[kElems], vi[kElems], sr[kElems], si[kElems];
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const int i = base + e * kThreads + tid;
        vr[e] = vi[e] = sr[e] = si[e] = 0.f;
        if (i < N) {
          vr[e] = xr[i];
          vi[e] = xi[i];
          if (i >= shift) {
            sr[e] = xr[i - shift];
            si[e] = xi[i - shift];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const int i = base + e * kThreads + tid;
        if (i < N) {
          const float shr = on_grid(sr[e], s_re, g);
          const float shi = on_grid(si[e], s_im, g);
          const float nr = __fadd_rn(
              vr[e], __fsub_rn(__fmul_rn(lr, shr), __fmul_rn(li, shi)));
          const float ni = __fadd_rn(
              vi[e], __fadd_rn(__fmul_rn(lr, shi), __fmul_rn(li, shr)));
          xr[i] = nr;
          xi[i] = ni;
          if (i < lim) {
            m.x = fmaxf(m.x, fabsf(nr));
            m.y = fmaxf(m.y, fabsf(ni));
          }
        }
      }
    }
    if (k + 1 < a.num_passes)
      amax = block_max(m);
    else
      __syncthreads();
  }

  // ---- the carry of block j - 1 ----
  if (j > 0 && tid == 0) wait_count(a.sync + 1 + b * nb + j - 1, n_cta);
  __syncthreads();
  const float* cin = a.cbuf + ((long long)b * nb + j - 1) * 2 * P;
  float2 cm = make_float2(0.f, 0.f);
  for (int i = tid; i < 2 * P; i += kThreads) {
    const float v = j > 0 ? __ldcg(cin + i) : 0.f;
    cs[i] = v;
    if (i < P)
      cm.x = fmaxf(cm.x, fabsf(v));
    else
      cm.y = fmaxf(cm.y, fabsf(v));
  }
  cm = cta_max2(cm);
  const float sc_re = scale_of(global ? gmax : cm.x, g);
  const float sc_im = scale_of(global ? gmax : cm.y, g);
  for (int c = tid; c < cpc; c += kThreads) {
    const int p = c0 + c;
    qc[c] = p < P ? on_grid(cs[p], sc_re, g) : 0.f;
    qc[cpc + c] = p < P ? on_grid(cs[P + p], sc_im, g) : 0.f;
  }
  __syncthreads();

  // ---- fold: x_r += lam^(r+1) * q(c) ----
  {
    const float qr = qc[ct], qi = qc[cpc + ct];
    m = make_float2(0.f, 0.f);
    for (int i = tid; i < N; i += kThreads) {
      const int r = i >> a.cpc_log2;
      const float tr = live ? a.ct_re[(long long)r * P + pt] : 0.f;
      const float ti = live ? a.ct_im[(long long)r * P + pt] : 0.f;
      const float vr = __fadd_rn(
          xr[i], __fsub_rn(__fmul_rn(tr, qr), __fmul_rn(ti, qi)));
      const float vi = __fadd_rn(
          xi[i], __fadd_rn(__fmul_rn(tr, qi), __fmul_rn(ti, qr)));
      xr[i] = vr;
      xi[i] = vi;
      m.x = fmaxf(m.x, fabsf(vr));
      m.y = fmaxf(m.y, fabsf(vi));
    }
  }
  amax = block_max(m);
  const float so_re = scale_of(global ? gmax : amax.x, g);
  const float so_im = scale_of(global ? gmax : amax.y, g);
  auto state = [&](float v, float s, float sq) {
    return requant(on_grid(v, s, g), sq, a.rq);
  };

  // ---- the carry onward: row t - 1, published ----
  if (j + 1 < nb) {
    float* cout = a.cbuf + ((long long)b * nb + j) * 2 * P;
    for (int c = tid; c < cpc; c += kThreads) {
      const int p = c0 + c;
      if (p < P) {
        const int i = (t - 1) * cpc + c;
        cout[p] = state(xr[i], so_re, a.rq.s_re);
        cout[P + p] = state(xi[i], so_im, a.rq.s_im);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(a.sync + 1 + b * nb + j, 1);
  }

  // ---- every state of the block ----
  for (int i = tid; i < N; i += kThreads) {
    const int r = i >> a.cpc_log2;
    const int row = j * t + r;
    if (row >= a.L || !live) continue;
    const float vr = state(xr[i], so_re, a.rq.s_re);
    const float vi = state(xi[i], so_im, a.rq.s_im);
    if (kMixer) {
      float* s = a.io + ((long long)b * a.L + row) * a.ld + pt;
      s[0] = vr;
      s[P] = vi;
    } else {
      const long long tau = a.reverse ? a.L - 1 - row : row;
      const long long at = ((long long)b * a.L + tau) * P + pt;
      a.out_re[at] = vr;
      a.out_im[at] = vi;
    }
  }
  cluster.sync();   // no CTA leaves while a rank may still read its partials
}

}  // namespace qat
