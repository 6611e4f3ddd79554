// Kernel K1: the diagonal complex recurrence over time, in either
// direction:
//   forward  x_t = lam * x_{t-1} + bu_t, with an optional initial carry
//            (streaming);
//   reverse  x_t = lam * x_{t+1} + bu_t, from a zero state past the end (the
//            backward half of a bidirectional mixer, and the adjoint of the
//            forward scan when called with conj(lam));
// and in either direction optionally with the serving engine's block
// requant: every state is written on a frozen grid (s_re, s_im, 2^(bits-1)
// codes; round half to even, then clip) and, at the end of each block of
// `block_t` steps of the walk, the running f32 state is replaced by its grid
// value, so the carry into the next block is the requantized last state.
// Blocks are counted from the walk's start: forward from t = 0, reverse
// from t = L - 1 (the JAX kernel flips the sequence, so its blocks align
// from the end).
//
// Replaces the TPU kernel sparsernns_tpu/ops/pallas/scan_kernel.py
// `pallas_diag_scan` (pallas_call at :494) in its float modes. On the TPU
// the grid walks time blocks in order, each block scanned by doubling
// passes in VMEM (`scan_block_body`), the incoming carry folded in with the
// table lam^(t+1), the carry kept in scratch.
//
// Bound: bytes. Read bu_re and bu_im once (2*B*L*P*4 bytes) and write
// x_re and x_im once (the same again); 8 flops per element (18 with the
// requant's division, rint and clip) are nothing against that. At the
// serving shape B=8, L=3751, P=128 that is 61.5 MB, 0.018 ms at 3.35 TB/s.
//
// Design: a time-chunked scan over the whole card. Every step depends on
// the one before it, so one thread walking all of time (B*P threads, B of
// the 132 SMs) is bound by latency. Time, in the walk's order, is cut into
// chunks that never straddle a block end of the requant (the wrapper's
// plan, ops/cuda/diag_scan.py `scan_plan`), and a call is three passes:
//   1. chunk pass, one-warp CTAs over (chunk, channel slice, batch row):
//      each thread scans its channels over the chunk from a zero state and
//      writes only the end state (every chunk but the last);
//   2. carry pass, one thread per (batch row, channel): chains the chunk
//      ends in order, carry_{k+1} = lam^{c_k} * carry_k + end_k, from the
//      initial carry (forward) or zero, and at a block end replaces it by
//      its grid value. The chain is the pass's latency, so the ends are
//      staged in shared memory ahead of it (cp.async). The two powers it
//      needs (a full chunk, a block's last chunk) are computed in float64
//      by square and multiply and rounded once: a rounded power is a
//      systematic error that the chain repeats at every chunk;
//   3. output pass, the CTAs of pass 1 over every chunk: each thread walks
//      its chunk again from its carry and writes the states. It reads back
//      no state of pass 1.
// That moves bu twice and the states once (1.5x the bound's bytes; the
// second read of bu may hit L2). A short sequence is one chunk: the output
// pass alone, one launch, its walk putting the carry on the grid at every
// block end. A thread owns 4 neighbouring channels (128-bit loads) where P
// allows it, else 1; a CTA is one warp, so a channel slice is 128 (or 32)
// channels, one coalesced row a half. Loads are issued kGroup rows ahead of
// the steps that use them.
//
// The block requant (more than one chunk) takes a block pass for pass 3.
// A grid code is a rounding of a state that two summation orders compute
// an ulp apart, so a code at a block end can flip, and the flipped carry
// is carried on through the channel: a chunked scan alone lands codes
// 2 apart from the sequential recurrence on the serving engine's layers.
// So passes 1-2 only predict each block's carry, and the block pass, one
// warp per (block, 32 channels, batch row), walks every block from its
// prediction sequentially, as the plain recurrence does; then, in ticket
// order (block-major: the block it waits on has an earlier ticket, so no
// residency can deadlock it), it waits for the block before to publish its
// last state on the grid and walks its block again where that differs
// from the prediction. The states are the sequential recurrence's, bit for
// bit; a flipped prediction costs one more walk of a block and channel.
//
// Numerics: every product and sum is rounded on its own (scan_step_rn), in
// every mode, as the plain recurrence rounds it, so that the plan's plain
// mirror (diag_scan_chunked_plain) repeats the kernel bit for bit. Division
// by the grid scale stays the IEEE v / s. The float modes' chunked scan
// rounds otherwise than the sequential walk (the carry's lam^c), within
// 1e-5 of max|x|.
//
// Launch options of the output pass, all off for every caller but the
// bidirectional mixer's (ops/scan.py BiDiagScanFn), whose launches they leave
// as they were: the states go to any (batch, time) strides, so that the two
// directions write their columns of one (B, L, 4P) matrix, the C-projection's
// input; the dλ epilogue, for an adjoint walk, sums v_t * conj(x) per
// channel over the chunk's rows, x the primal state at the walk's next row
// (zero past the walk's end), into one partial per (batch row, chunk,
// channel), which the wrapper reduces in a fixed order; and with it
// `accumulate` adds each state to what the output holds, one rounded f32
// add, the walk carrying its own state (the second adjoint adds its
// cotangent to the first's, as autograd's one add does). The epilogue reads
// the saved states once more (2 of the call's 6 element reads and writes;
// accumulate 2 more).
//
// Each launch is recorded with its grid; diag_scan_launched hands the
// wrapper the record of the last call.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "scan_step.cuh"

namespace {

constexpr int kLanes = 32;   // threads of a CTA: one warp
constexpr int kGroup = 8;    // rows loaded before their steps
constexpr int kSeg = 64;     // chunk ends the carry pass stages at a time
constexpr int kRing = 16;    // rows a stage of the block walk's ring holds
constexpr int kStages = 8;   // stages of the ring (kStages - 1 in flight)
// epilogues of the output pass (flags)
constexpr int kAcc = 1;      // add every state to what the output holds
constexpr int kDlam = 2;     // sum v_t * conj(x at the walk's next row)

struct Args {
  const float* bu_re;
  const float* bu_im;
  long long sb, st;            // element strides of bu (batch, time)
  const float* lam_re;
  const float* lam_im;
  const float* c_re;           // (B, P) carry before the first row, or null
  const float* c_im;
  float* link;                 // (B, n_chunks - 1, 2P): ends, then carries
  float* block_ends;           // (B, n_blocks, 2P): block ends on the grid
  int* sync;                   // 1 ticket counter, (B, n_blocks, P / 32) flags
  float* out_re;               // (B, L, P) with element strides (osb, ost, 1)
  float* out_im;
  long long osb, ost;
  const float* xs_re;          // dλ: the primal states (B, L, P), strides
  const float* xs_im;          //     (xsb, xst, 1); or null
  long long xsb, xst;
  float* dlam;                 // dλ: (B, n_chunks, 2P) partials, or null
  int B, L, P, reverse;
  int chunk, block, per_block, n_chunks, n_blocks;
  int rq_block;                // the requant's block, in walk steps
  float s_re, s_im, qmin, qmax;
  float inv_re, inv_im;        // 1 / s where that is exact (kRq 2)
};

struct Chunk {
  int s0, len;
};

// Chunk k: its first walk step and its rows.
__device__ __forceinline__ Chunk chunk_of(const Args& a, int k) {
  const int j = k / a.per_block;
  const int i = k - j * a.per_block;
  Chunk c;
  c.s0 = j * a.block + i * a.chunk;
  c.len = min(min(a.chunk, a.block - i * a.chunk), a.L - c.s0);
  return c;
}

// v on the frozen grid: its code round(v / s), clipped, times s. kRq 2
// takes v * (1 / s) for v / s: bit-equal where s is a power of two whose
// reciprocal is a normal float (both round the same real number, into the
// subnormals too), and free of the division's branch, so that the steps
// of a walk interleave; kRq 1 divides (any other scale).
template <int kRq>
__device__ __forceinline__ float grid_value(float v, float s, float inv,
                                            float qmin, float qmax) {
  const float q = kRq == 2 ? __fmul_rn(v, inv) : v / s;
  return __fmul_rn(fminf(fmaxf(rintf(q), qmin), qmax), s);
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = __ldg(p + v);
  }
}

// A load of memory this kernel writes afterwards (no read-only path).
template <int V>
__device__ __forceinline__ void load_rw(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) x[v] = p[v];
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = x[v];
  }
}

// Passes 1 (kOut false: the chunk's end state into `link`) and 3 (kOut
// true: every state into out; with the requant only for a plan of one chunk,
// whose walk puts the carry on the grid at every block end; kEpi the output
// pass's epilogues, float modes only). Grid (chunk, channel slice, batch
// row), one warp a CTA, V channels a thread.
template <int V, int kRq, bool kOut, int kEpi>
__global__ void __launch_bounds__(kLanes) k1_walk_kernel(const Args a) {
  constexpr bool kRequant = kRq != 0;
  constexpr bool kAdd = (kEpi & kAcc) != 0;
  constexpr bool kDl = (kEpi & kDlam) != 0;
  static_assert(kEpi == 0 || (kOut && !kRequant), "epilogues: float output");
  const int k = blockIdx.x;
  const int p0 = (blockIdx.y * kLanes + threadIdx.x) * V;
  const int b = blockIdx.z;
  if (p0 >= a.P) return;
  const Chunk c = chunk_of(a, k);
  const long long lb = (long long)b * (a.n_chunks - 1) * 2 * a.P;
  float lr[V], li[V], xr[V], xi[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    lr[v] = a.lam_re[p0 + v];
    li[v] = a.lam_im[p0 + v];
    xr[v] = xi[v] = 0.f;
  }
  if (kOut && k > 0) {
    const float* in = a.link + lb + (long long)(k - 1) * 2 * a.P + p0;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xr[v] = in[v];
      xi[v] = in[a.P + v];
    }
  } else if (kOut && a.c_re != nullptr) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xr[v] = a.c_re[(long long)b * a.P + p0 + v];
      xi[v] = a.c_im[(long long)b * a.P + p0 + v];
    }
  }
  int to_end = kRequant ? a.rq_block - c.s0 % a.rq_block : 0;
  // bu's and the output's rows in the walk's order, from the chunk's first
  // step on, as running pointers
  const long long t0 = a.reverse ? a.L - 1 - c.s0 : c.s0;
  const long long ds = a.reverse ? -a.st : a.st;
  const float* in_r = a.bu_re + b * a.sb + t0 * a.st + p0;
  const float* in_i = a.bu_im + b * a.sb + t0 * a.st + p0;
  const long long dt = a.reverse ? -a.ost : a.ost;
  float* o_r = a.out_re + b * a.osb + t0 * a.ost + p0;
  float* o_i = a.out_im + b * a.osb + t0 * a.ost + p0;
  // dλ: the primal state at the walk's next row of chunk row r, for the
  // chunk's first n_dl rows (the walk's last row has none: a zero)
  const long long dx = a.reverse ? -a.xst : a.xst;
  const long long x0 = b * a.xsb + t0 * a.xst + dx + p0;
  const int n_dl = kDl ? min(c.len, a.L - 1 - c.s0) : 0;
  float dr[V], di[V];
#pragma unroll
  for (int v = 0; v < V; ++v) dr[v] = di[v] = 0.f;
  auto next_state = [&](int r, float(&nr)[V], float(&ni)[V]) {
    if (r < n_dl) {
      load<V>(a.xs_re + x0 + r * dx, nr);
      load<V>(a.xs_im + x0 + r * dx, ni);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) nr[v] = ni[v] = 0.f;
    }
  };
  // one row of the walk: the state advances, and the output pass writes
  // it (on the grid with the requant, the carry on it at a block end; with
  // the epilogues added to what the output held (pr, pi), and its product
  // with the conjugate next state (nr, ni) summed)
  auto step = [&](const float(&ur)[V], const float(&ui)[V],
                  const float(&pr)[V], const float(&pi)[V],
                  const float(&nr)[V], const float(&ni)[V]) {
    float wr[V], wi[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      scan::scan_step_rn(lr[v], li[v], ur[v], ui[v], xr[v], xi[v]);
      wr[v] = xr[v];
      wi[v] = xi[v];
    }
    if constexpr (kDl) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        dr[v] = fmaf(wr[v], nr[v], fmaf(wi[v], ni[v], dr[v]));
        di[v] = fmaf(wi[v], nr[v], fmaf(-wr[v], ni[v], di[v]));
      }
    }
    if constexpr (kAdd) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        wr[v] = __fadd_rn(pr[v], wr[v]);
        wi[v] = __fadd_rn(pi[v], wi[v]);
      }
    }
    if (kRequant) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        wr[v] = grid_value<kRq>(xr[v], a.s_re, a.inv_re, a.qmin, a.qmax);
        wi[v] = grid_value<kRq>(xi[v], a.s_im, a.inv_im, a.qmin, a.qmax);
      }
      if (--to_end == 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          xr[v] = wr[v];
          xi[v] = wi[v];
        }
        to_end = a.rq_block;
      }
    }
    if (kOut) {
      store<V>(o_r, wr);
      store<V>(o_i, wi);
      o_r += dt;
      o_i += dt;
    }
  };
  // the epilogues' operands of a group's rows (one slot where off)
  constexpr int kP = kAdd ? kGroup : 1, kN = kDl ? kGroup : 1;
  for (int r0 = 0; r0 < c.len; r0 += kGroup) {
    float ur[kGroup][V], ui[kGroup][V];
    float pr[kP][V], pi[kP][V], nr[kN][V], ni[kN][V];
    const int m = min(kGroup, c.len - r0);
    if (m == kGroup) {
      // a full group is one basic block: its loads are all issued before
      // the first step waits, and the steps interleave
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        load<V>(in_r + g * ds, ur[g]);
        load<V>(in_i + g * ds, ui[g]);
        if constexpr (kAdd) {
          load_rw<V>(o_r + g * dt, pr[g]);
          load_rw<V>(o_i + g * dt, pi[g]);
        }
        if constexpr (kDl) next_state(r0 + g, nr[g], ni[g]);
      }
      in_r += kGroup * ds;
      in_i += kGroup * ds;
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        step(ur[g], ui[g], pr[kAdd ? g : 0], pi[kAdd ? g : 0],
             nr[kDl ? g : 0], ni[kDl ? g : 0]);
    } else {
      for (int g = 0; g < m; ++g) {
        load<V>(in_r, ur[0]);
        load<V>(in_i, ui[0]);
        if constexpr (kAdd) {
          load_rw<V>(o_r, pr[0]);
          load_rw<V>(o_i, pi[0]);
        }
        if constexpr (kDl) next_state(r0 + g, nr[0], ni[0]);
        in_r += ds;
        in_i += ds;
        step(ur[0], ui[0], pr[0], pi[0], nr[0], ni[0]);
      }
    }
  }
  if (!kOut) {
    float* out = a.link + lb + (long long)k * 2 * a.P + p0;
    store<V>(out, xr);
    store<V>(out + a.P, xi);
  }
  if constexpr (kDl) {
    float* out = a.dlam + ((long long)b * a.n_chunks + k) * 2 * a.P + p0;
    store<V>(out, dr);
    store<V>(out + a.P, di);
  }
}

// lam^e in float64 by square and multiply (bits of e from the lowest),
// every product and sum rounded on its own, then rounded to float32 once.
__device__ __forceinline__ void power(double lr, double li, int e, float& pr,
                                      float& pi) {
  double rr = 1.0, ri = 0.0, br = lr, bi = li;
  while (e) {
    if (e & 1) {
      const double tr = __dsub_rn(__dmul_rn(rr, br), __dmul_rn(ri, bi));
      const double ti = __dadd_rn(__dmul_rn(rr, bi), __dmul_rn(ri, br));
      rr = tr;
      ri = ti;
    }
    e >>= 1;
    if (e) {
      const double sr = __dsub_rn(__dmul_rn(br, br), __dmul_rn(bi, bi));
      const double si = __dadd_rn(__dmul_rn(br, bi), __dmul_rn(bi, br));
      br = sr;
      bi = si;
    }
  }
  pr = __double2float_rn(rr);
  pi = __double2float_rn(ri);
}

// Pass 2: one thread per (batch row, channel), grid (ceil(P / 32), B). The
// chunk ends are staged in shared memory kSeg chunks at a time (cp.async,
// the next segment in flight while the chain walks this one), so that the
// chain waits on no load from device memory.
template <int kRq>
__global__ void __launch_bounds__(kLanes) k1_carry_kernel(const Args a) {
  constexpr bool kRequant = kRq != 0;
  __shared__ float ends[2][kSeg][2][kLanes];
  const int lane = threadIdx.x;
  const int p = blockIdx.x * kLanes + lane;
  const int b = blockIdx.y;
  if (kRequant) {   // the block pass's flags of this (batch row, slice)
    const int slices = (a.P + kLanes - 1) / kLanes;
    for (int j = lane; j < a.n_blocks; j += kLanes)
      a.sync[1 + ((long long)b * a.n_blocks + j) * slices + blockIdx.x] = 0;
    if (b == 0 && blockIdx.x == 0 && lane == 0) a.sync[0] = 0;
  }
  if (p >= a.P) return;
  const int n = a.n_chunks - 1;
  float* link = a.link + (long long)b * n * 2 * a.P + p;
  const int n_seg = (n + kSeg - 1) / kSeg;
  auto stage = [&](int seg) {
    const int k0 = seg * kSeg;
    const int m = min(kSeg, n - k0);
    for (int g = 0; g < m; ++g) {
      const float* src = link + (long long)(k0 + g) * 2 * a.P;
      __pipeline_memcpy_async(&ends[seg & 1][g][0][lane], src, 4);
      __pipeline_memcpy_async(&ends[seg & 1][g][1][lane], src + a.P, 4);
    }
    __pipeline_commit();
  };
  stage(0);
  // lam^chunk and lam^tail (a block's last chunk)
  const double lr = a.lam_re[p], li = a.lam_im[p];
  float fr, fi, tr, ti;
  power(lr, li, a.chunk, fr, fi);
  power(lr, li, a.block - (a.per_block - 1) * a.chunk, tr, ti);
  float xr = 0.f, xi = 0.f;
  if (a.c_re != nullptr) {
    xr = a.c_re[(long long)b * a.P + p];
    xi = a.c_im[(long long)b * a.P + p];
  }
  // chunk k < n ends a block where its index within the block is the last
  int i = 0;
  for (int seg = 0; seg < n_seg; ++seg) {
    if (seg + 1 < n_seg)
      stage(seg + 1);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);
    const int k0 = seg * kSeg;
    const int m = min(kSeg, n - k0);
    const float(*seg_ends)[2][kLanes] = ends[seg & 1];
    for (int g = 0; g < m; ++g) {
      const bool end = i == a.per_block - 1;
      scan::scan_step_rn(end ? tr : fr, end ? ti : fi, seg_ends[g][0][lane],
                         seg_ends[g][1][lane], xr, xi);
      if (kRequant && end) {
        xr = grid_value<kRq>(xr, a.s_re, a.inv_re, a.qmin, a.qmax);
        xi = grid_value<kRq>(xi, a.s_im, a.inv_im, a.qmin, a.qmax);
      }
      link[(long long)(k0 + g) * 2 * a.P] = xr;
      link[(long long)(k0 + g) * 2 * a.P + a.P] = xi;
      i = end ? 0 : i + 1;
    }
  }
}

// Walks one channel over walk steps [s0, s0 + len) of a requant block from
// the carry (xr, xi), sequentially as the plain recurrence does, writing
// every state on the grid; (er, ei) is the last state on the grid: the
// carry onward. The lane's bu reaches it through a ring of kStages stages
// of kRing rows in shared memory (cp.async, kStages - 1 stages in flight
// ahead of the steps): a block is walked by 2 warps an SM, which hide no
// latency for each other.
template <int kRq>
__device__ __forceinline__ void walk_block(const Args& a,
                                           float (*ring)[kRing][2][kLanes],
                                           int b, int p, int s0, int len,
                                           float xr, float xi, float& er,
                                           float& ei) {
  const int lane = threadIdx.x;
  const float lr = a.lam_re[p], li = a.lam_im[p];
  // bu's and the output's rows in the walk's order, from walk step s0 on,
  // as running pointers: no per-row product of a row and a stride
  const long long t0 = a.reverse ? a.L - 1 - s0 : s0;
  const long long ds = a.reverse ? -a.st : a.st;
  const long long dt = a.reverse ? -a.ost : a.ost;
  const float* in_r = a.bu_re + b * a.sb + t0 * a.st + p;
  const float* in_i = a.bu_im + b * a.sb + t0 * a.st + p;
  float* o_r = a.out_re + b * a.osb + t0 * a.ost + p;
  float* o_i = a.out_im + b * a.osb + t0 * a.ost + p;
  const int n_stage = (len + kRing - 1) / kRing;
  int issued = 0;   // rows whose copies are issued, in order
  auto issue = [&](int stage) {
    for (int g = 0; g < kRing; ++g) {
      if (stage < n_stage && issued < len) {
        __pipeline_memcpy_async(&ring[stage % kStages][g][0][lane], in_r, 4);
        __pipeline_memcpy_async(&ring[stage % kStages][g][1][lane], in_i, 4);
        in_r += ds;
        in_i += ds;
        ++issued;
      }
    }
    __pipeline_commit();
  };
  for (int stage = 0; stage < kStages - 1; ++stage) issue(stage);
  float wr = 0.f, wi = 0.f;
  auto step = [&](float ur, float ui) {
    scan::scan_step_rn(lr, li, ur, ui, xr, xi);
    wr = grid_value<kRq>(xr, a.s_re, a.inv_re, a.qmin, a.qmax);
    wi = grid_value<kRq>(xi, a.s_im, a.inv_im, a.qmin, a.qmax);
    *o_r = wr;
    *o_i = wi;
    o_r += dt;
    o_i += dt;
  };
  for (int stage = 0; stage < n_stage; ++stage) {
    issue(stage + kStages - 1);
    __pipeline_wait_prior(kStages - 1);
    const float(*rows)[2][kLanes] = ring[stage % kStages];
    const int m = min(kRing, len - stage * kRing);
    if (m == kRing) {
      // one warp an SM quarter issues in order: a full stage is one basic
      // block, its rows in registers before the first store, so that each
      // row's grid and stores fill the next row's wait
      float ur[kRing], ui[kRing];
#pragma unroll
      for (int g = 0; g < kRing; ++g) {
        ur[g] = rows[g][0][lane];
        ui[g] = rows[g][1][lane];
      }
#pragma unroll
      for (int g = 0; g < kRing; ++g) step(ur[g], ui[g]);
    } else {
      for (int g = 0; g < m; ++g) step(rows[g][0][lane], rows[g][1][lane]);
    }
  }
  __pipeline_wait_prior(0);
  er = wr;
  ei = wi;
}

// Spins until *flag is set (a wait past ~4 s traps: the launch then fails
// with an error instead of hanging).
__device__ inline void wait_flag(int* flag) {
  unsigned ns = 32;
  long long spins = 0;
  while (atomicAdd(flag, 0) == 0) {
    __nanosleep(ns);
    if (ns < 256) ns *= 2;
    if (++spins > (1ll << 24)) __trap();
  }
  __threadfence();
}

// Pass 3 with the block requant (a plan of more than one chunk): one warp
// per (requant block, 32 channels, batch row), in ticket order (block-major,
// so the block a CTA waits on belongs to a CTA with an earlier ticket). Each
// lane walks its channel over the block sequentially from the carry that
// passes 1-2 predicted, then waits for the block before to publish its last
// state on the grid; where that differs from the prediction (a state the
// two summation orders rounded to different codes) it walks the block again
// from it. The states are then those of the sequential recurrence, bit for
// bit, and the block's last state on the grid is published for the next.
template <int kRq>
__global__ void __launch_bounds__(kLanes) k1_block_kernel(const Args a) {
  __shared__ float ring[kStages][kRing][2][kLanes];
  const int lane = threadIdx.x;
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(a.sync, 1);
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  const int slices = (a.P + kLanes - 1) / kLanes;
  const int slice = ticket % slices;
  const int b = ticket / slices % a.B;
  const int j = ticket / slices / a.B;
  const int p = slice * kLanes + lane;
  const bool live = p < a.P;
  const int s0 = j * a.block;
  const int len = min(a.block, a.L - s0);
  const long long row = (long long)b * a.n_blocks;
  float cr = 0.f, ci = 0.f, er = 0.f, ei = 0.f;
  if (live && j > 0) {
    const float* in = a.link +
                      ((long long)b * (a.n_chunks - 1) + j * a.per_block - 1) *
                          2 * a.P + p;
    cr = in[0];
    ci = in[a.P];
  } else if (live && a.c_re != nullptr) {
    cr = a.c_re[(long long)b * a.P + p];
    ci = a.c_im[(long long)b * a.P + p];
  }
  // round 0 walks from the prediction; round 1, where the block before
  // ended elsewhere in any lane, the whole warp walks again from the
  // block before's ends (a lane whose carry was right repeats its states
  // bit for bit)
  for (int round = 0; round < 2; ++round) {
    if (round == 1) {
      if (j == 0) break;
      if (lane == 0) wait_flag(a.sync + 1 + (row + j - 1) * slices + slice);
      __syncwarp();
      bool off = false;
      if (live) {
        const float* in = a.block_ends + (row + j - 1) * 2 * a.P + p;
        const float tr = __ldcg(in), ti = __ldcg(in + a.P);
        off = __float_as_int(tr) != __float_as_int(cr) ||
              __float_as_int(ti) != __float_as_int(ci);
        cr = tr;
        ci = ti;
      }
      if (!__any_sync(0xffffffffu, off)) break;
    }
    if (live) walk_block<kRq>(a, ring, b, p, s0, len, cr, ci, er, ei);
  }
  if (j + 1 < a.n_blocks) {
    if (live) {
      float* out = a.block_ends + (row + j) * 2 * a.P + p;
      out[0] = er;
      out[a.P] = ei;
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicExch(a.sync + 1 + (row + j) * slices + slice, 1);
  }
}

struct Launch {
  const char* name;
  int grid[3];
  int threads;
};
constexpr int kMaxRecord = 4;
Launch g_record[kMaxRecord];
int g_n_record = 0;

void record(const char* name, dim3 grid) {
  if (g_n_record < kMaxRecord)
    g_record[g_n_record++] = {
        name, {(int)grid.x, (int)grid.y, (int)grid.z}, kLanes};
}

template <int V, int kRq, bool kOut, int kEpi = 0>
cudaError_t launch_walk(const Args& a, cudaStream_t st) {
  const int slices = (a.P + kLanes * V - 1) / (kLanes * V);
  const dim3 grid(kOut ? a.n_chunks : a.n_chunks - 1, slices, a.B);
  k1_walk_kernel<V, kRq, kOut, kEpi><<<grid, kLanes, 0, st>>>(a);
  record(kOut ? "k1_out_pass" : "k1_chunk_pass", grid);
  return cudaGetLastError();
}

// The output pass with the epilogues `epi` (float modes only): none, dλ,
// or dλ with accumulate, the adjoint's two uses; accumulate alone is not
// built (diag_scan_run refuses it).
template <int V, int kRq>
cudaError_t launch_out(const Args& a, int epi, cudaStream_t st) {
  if constexpr (kRq != 0) {
    return launch_walk<V, kRq, true>(a, st);
  } else {
    switch (epi) {
      case kDlam:
        return launch_walk<V, 0, true, kDlam>(a, st);
      case kAcc | kDlam:
        return launch_walk<V, 0, true, kAcc | kDlam>(a, st);
      default:
        return launch_walk<V, 0, true>(a, st);
    }
  }
}

template <int V, int kRq>
cudaError_t launch_all(const Args& a, int epi, cudaStream_t st) {
  if (a.n_chunks > 1) {
    cudaError_t err = launch_walk<V, 0, false>(a, st);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.P + kLanes - 1) / kLanes, a.B);
    k1_carry_kernel<kRq><<<grid, kLanes, 0, st>>>(a);
    record("k1_carry_pass", grid);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (kRq != 0) {
      const dim3 blocks(a.n_blocks, (a.P + kLanes - 1) / kLanes, a.B);
      k1_block_kernel<kRq><<<blocks, kLanes, 0, st>>>(a);
      record("k1_block_pass", blocks);
      return cudaGetLastError();
    }
  }
  return launch_out<V, kRq>(a, epi, st);
}

}  // namespace

// bu_re/bu_im: (B, L, P) views with element strides (stride_b, stride_t, 1)
// -- they may be the two halves of one (B, L, 2P) tensor; with vec = 4 the
// strides and addresses are multiples of 4 floats. c_re/c_im: (B, P)
// contiguous, or null for a zero initial state (the reverse direction takes
// no carry: the caller passes null). scratch: the chunks' links (B,
// n_chunks - 1, 2P floats), then with the requant and more than one chunk
// the blocks' ends (B, ceil(L / block), 2P floats) and the block pass's
// ticket and flags (1 + B * ceil(L / block) * ceil(P / 32) ints).
// out_re/out_im: (B, L, P) views with element strides (out_sb, out_st, 1),
// with vec = 4 multiples of 4 floats (the columns of a wider matrix; a
// contiguous output: L * P, P). reverse: 0 forward in time,
// 1 backward. chunk, block, per_block, n_chunks: the plan's chunks, in the
// walk's order. requant 1 puts every state on (s_re, s_im) with codes in
// [qmin, qmax] and the carry on the grid after every rq_block steps of the
// walk. vec: channels a thread of passes 1 and 3 (4 or 1). inv_re/inv_im:
// 1 / s_re and 1 / s_im where the scale is a power of two whose reciprocal
// is a normal float (the grid then multiplies, bit-equal), else 0 (it
// divides). xs_re/xs_im: null, or the primal states (B, L, P) with element
// strides (xs_sb, xs_st, 1), aligned as out: the output pass then writes
// dλ's partial sums into dlam (B, n_chunks, 2P floats), and accumulate 1
// adds every state to what out holds (only with xs_re). The epilogues take
// no requant. Returns the first launch error.
extern "C" int diag_scan_run(
    const float* bu_re, const float* bu_im, long long stride_b,
    long long stride_t, const float* lam_re, const float* lam_im,
    const float* c_re, const float* c_im, float* scratch, float* out_re,
    float* out_im, int B, int L, int P, int reverse, int chunk, int block,
    int per_block, int n_chunks, int rq_block, int requant, int vec,
    float s_re, float s_im, float qmin, float qmax, float inv_re,
    float inv_im, long long out_sb, long long out_st, int accumulate,
    const float* xs_re, const float* xs_im, long long xs_sb, long long xs_st,
    float* dlam, void* stream) {
  g_n_record = 0;
  const int epi = (accumulate ? kAcc : 0) | (xs_re != nullptr ? kDlam : 0);
  if (chunk < 1 || block < chunk || per_block < 1 || n_chunks < 1 ||
      (requant && rq_block < 1) || (vec != 1 && vec != 4) ||
      (vec == 4 && P % 4 != 0) || (epi != 0 && requant) ||
      (accumulate && xs_re == nullptr) ||
      (xs_re != nullptr && (xs_im == nullptr || dlam == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.bu_re = bu_re;
  a.bu_im = bu_im;
  a.sb = stride_b;
  a.st = stride_t;
  a.lam_re = lam_re;
  a.lam_im = lam_im;
  a.c_re = c_re;
  a.c_im = c_im;
  a.n_blocks = (L + block - 1) / block;
  a.link = scratch;
  a.block_ends = scratch + (long long)B * (n_chunks - 1) * 2 * P;
  a.sync = reinterpret_cast<int*>(a.block_ends +
                                  (long long)B * a.n_blocks * 2 * P);
  a.out_re = out_re;
  a.out_im = out_im;
  a.osb = out_sb;
  a.ost = out_st;
  a.xs_re = xs_re;
  a.xs_im = xs_im;
  a.xsb = xs_sb;
  a.xst = xs_st;
  a.dlam = dlam;
  a.B = B;
  a.L = L;
  a.P = P;
  a.reverse = reverse;
  a.chunk = chunk;
  a.block = block;
  a.per_block = per_block;
  a.n_chunks = n_chunks;
  a.rq_block = requant ? rq_block : 1;
  a.s_re = s_re;
  a.s_im = s_im;
  a.qmin = qmin;
  a.qmax = qmax;
  a.inv_re = inv_re;
  a.inv_im = inv_im;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rq = !requant ? 0 : inv_re != 0.f && inv_im != 0.f ? 2 : 1;
  cudaError_t err;
  if (vec == 4)
    err = rq == 2   ? launch_all<4, 2>(a, epi, st)
          : rq == 1 ? launch_all<4, 1>(a, epi, st)
                    : launch_all<4, 0>(a, epi, st);
  else
    err = rq == 2   ? launch_all<1, 2>(a, epi, st)
          : rq == 1 ? launch_all<1, 1>(a, epi, st)
                    : launch_all<1, 0>(a, epi, st);
  return (int)err;
}

// The launches of the last call, in order: up to `cap` pass names, grids
// (x, y, z) and threads a CTA; returns how many it made.
extern "C" int diag_scan_launched(const char** names, int* grids,
                                  int* threads, int cap) {
  for (int i = 0; i < g_n_record && i < cap; ++i) {
    names[i] = g_record[i].name;
    for (int d = 0; d < 3; ++d) grids[3 * i + d] = g_record[i].grid[d];
    threads[i] = g_record[i].threads;
  }
  return g_n_record;
}
