// The serving engine's kernels K6 (engine_network.cu) and K5a / K5b
// (engine_layer.cu) as passes over the whole card: row passes over the
// flattened B * L frames, and between them one scan per layer over every
// (batch row, state channel).
//
// A layer is three parts (engine_body.cuh): its head (norm, B-projection,
// quant_but), its recurrence (in time order, the block requant, relu, the
// C-side scale) and its tail (C-projection + d * z, quant_yt, activation,
// GLU, residual, postnorm, relufication, the output requant). Only the
// recurrence couples frames, and only along time within one (batch row,
// channel). So:
//
//   row pass   (engine_row_pass_kernel) a CTA owns kT consecutive rows of
//              the flattened (B * L) stream, which may straddle two batch
//              rows, and all H columns of each: [encoder or the stream as
//              stored] -> [tail of layer l] -> [stream store] -> [head of
//              layer l + 1 -> bu] -> [decoder]. The stream between passes
//              is stored as float32 values; the tail recomputes z from it.
//   scan pass  (engine_scan_pass_kernel) a thread per (batch row, channel)
//              walks all L steps of bu in order (scan_step_rn) and writes
//              each raw state in place of bu; where a block ends the
//              running state goes on the grid (mixer_grid), the carry into
//              the next block. The carry in and out (K5b) is read and
//              written here. Only this is serial: the grid value of every
//              state, relu and the C-side scale (mixer_grid, mixer_read)
//              are elementwise and run in the next row pass, as its tail
//              loads the states.
//
// K6 = n_layers + 1 row passes and n_layers scans; K5 = a head pass, a
// scan, a tail pass; the mixer alone (fused_s5.cu, K4a / K4b) the same
// three, with no norm (prenorm off), no GLU, residual or stream requant:
// its tail pass stores y = the C-projection + d * u and stops. Every
// product and requant is the same device function of engine_body.cuh, in
// the same order, as in the one-CTA-per-row kernels the passes replaced:
// each output element of a product is one fmaf chain in ascending k from
// 0, integer dots are exact, the scan steps without contraction. So the
// passes give the values those kernels gave, K6 equals the K5 stack bit
// for bit, the per-op route's mixer rounds as the stack does, and K5b /
// K4b over chunks of whole blocks equal one call.
//
// Each launch is recorded with its grid (read_launched, behind
// engine_network_launched, engine_layer_launched and fused_s5_launched), so
// the wrapper can read back the passes that ran.

#pragma once

#include "engine_body.cuh"

namespace engine {

constexpr int kScanThreads = 32;  // state channels of a scan CTA (one warp)
constexpr int kScanUnroll = 16;   // steps of bu in flight in a scan thread

// One row pass. The layout is private to the CUDA side.
struct RowPass {
  const void* in;      // encoder: (rows, d_in); else the stream (rows, H)
  const float* s_in;   // tail: the raw states, (rows, ld_bu) f32
  float* bu_out;       // head: bu, (rows, ld_bu) f32
  float* stream_out;   // the stream values (rows, H) f32; null: not stored
  void* out;           // decoder output (rows, d_out), or with codes_out
                       // the layer's stream as stored (rows, H)
  float* y_out;        // the mixer alone (K4a / K4b): y (rows, H) f32, and
                       // the tail stops after the C-projection, with no
                       // residual tile (Z is R); else null
  LayerParams tail, head;
  DenseW enc, dec;     // w null: stage absent
  Mode mode;
  long long n_rows;    // B * L
  float in_scale;      // stream codes -> values (1 for float streams)
  int in_type, out_type;
  int has_tail, has_head, codes_out;
  int d_in, d_out;
  int ld_bu;           // a row of bu / S in device memory: 2 * the widest
                       // P, so every layer's tile covers the same bytes
  int ldp;             // round4(ld_bu): a row of the S tile
  int ldq;             // bytes a row of the code tile Q for this pass's
                       // integer dots (0: none)
};

// One scan: the recurrence of one layer over (B, L), in place.
struct ScanPass {
  LayerParams lp;
  float* S;            // (B, L, ld): bu in, the raw states out ([re | im]
                       // in the first 2P of a row)
  const float* ci_re;  // (B, P) carry in, null: zero
  const float* ci_im;
  float* co_re;        // (B, P) carry out, null: not returned
  float* co_im;
  int ld;
  int B, L, block_t;
};

// Floats of a row pass's shared memory after R and Z: the tail's Y and S,
// or the encoder's input tile, which no tail shares a pass with.
__host__ __device__ inline int union_width(const RowPass& a) {
  const int ldh = round4(a.mode.h);
  return imax(a.has_tail ? ldh + a.ldp : 0, a.enc.w ? round4(a.d_in) : 0);
}

// Whether the code tile Q lives in the S tile of a pass with a tail: the
// float C-projection is done with S before any later dot quantizes into Q,
// and the integer C-projection takes the states' codes in Q, no S.
__host__ __device__ inline bool q_in_s(const RowPass& a) {
  return a.has_tail && 2 * a.ldq <= 4 * a.ldp;
}

__global__ void __launch_bounds__(kThreads, 2)
engine_row_pass_kernel(const __grid_constant__ RowPass a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Mode& m = a.mode;
  const int H = m.h, ldh = round4(H);
  float* R = smem;
  // the mixer alone has no residual: its input is z, and R its tile
  float* Z = a.y_out ? R : R + kT * ldh;
  float* Y = Z + kT * ldh;
  float* S = Y + kT * ldh;
  float* X = Y;
  int8_t* Q = reinterpret_cast<int8_t*>(q_in_s(a) ? S
                                                  : Y + kT * union_width(a));
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kT;
  const int rows = (int)min((long long)kT, a.n_rows - row0);

  // ---- the tile's stream values: the encoder, or the stream as stored ----
  if (a.enc.w) {
    const int ldx = round4(a.d_in);
    load_tile(X, ldx, a.in, a.in_type, row0, a.d_in, rows, 1.f);
    __syncthreads();
    encode_tile(X, ldx, a.enc, a.d_in, m, R, ldh, rows, Q, a.ldq);
  } else {
    load_tile(R, ldh, a.in, a.in_type, row0, H, rows, a.in_scale);
  }
  __syncthreads();

  // ---- tail of a layer: its output h replaces R ----
  if (a.has_tail) {
    const LayerParams& lp = a.tail;
    const int P = lp.p;
    layer_norm(lp, m, R, Z, ldh, rows);
    // the states as the C-projection reads them: floats in S, or with
    // state16 their codes in Q (quant_tile's arithmetic)
    const int p4 = round4(P);
    for (int i = tid; i < rows * P; i += blockDim.x) {
      const int r = i / P, p = i % P;
      const float* x = a.s_in + (row0 + r) * a.ld_bu + p;
      float sr, si, wr, wi;
      mixer_grid(lp, x[0], x[P], sr, si);
      mixer_read(lp, m.relu_state, sr, si, wr, wi);
      if (lp.st_mode) {
        put_code(Q, a.ldq, r, p, (int)quant_code(wr, 1.f, lp.sq_min,
                                                  lp.sq_max), lp.st_mode);
        put_code(Q, a.ldq, r, p4 + p,
                 (int)quant_code(wi, 1.f, lp.sq_min, lp.sq_max), lp.st_mode);
      } else {
        S[r * a.ldp + p] = wr;
        S[r * a.ldp + P + p] = wi;
      }
    }
    __syncthreads();
    if (lp.ut_mode) {   // the D term's operand: z on the quant_ut grid
      const float qmax = grid_max(lp.ut_bits);
      for (int i = tid; i < rows * H; i += blockDim.x) {
        float* z = Z + (i / H) * ldh + i % H;
        *z = __fmul_rn(quant_code(*z, lp.ut_s, -qmax - 1.f, qmax), lp.ut_s);
      }
      __syncthreads();
    }
    mixer_cproj(lp, H, Z, Y, S, ldh, a.ldp, rows, Q, a.ldq);
    __syncthreads();
    if (a.y_out) {   // the mixer alone: y is the result
      for (int i = tid; i < rows * H; i += blockDim.x)
        a.y_out[row0 * H + i] = Y[(i / H) * ldh + i % H];
      return;
    }
    layer_finish(lp, m, R, Z, Y, ldh, rows, Q, a.ldq);
    if (a.codes_out) {   // the layer's stream as stored: the last pass
      for (int i = tid; i < rows * H; i += blockDim.x) {
        const float h = R[(i / H) * ldh + i % H];
        store_io(a.out, row0 * H + i, a.out_type,
                 lp.has_rq ? quant_code(h, lp.rq_s, lp.rq_min, lp.rq_max)
                           : h);
      }
      return;
    }
    for (int i = tid; i < rows * H; i += blockDim.x) {
      float* v = R + (i / H) * ldh + i % H;
      *v = stream_value(*v, lp, m.act_bf16);
    }
    __syncthreads();
  }

  // ---- the stream for the next pass (in place of the rows read) ----
  if (a.stream_out) {
    for (int i = tid; i < rows * H; i += blockDim.x)
      a.stream_out[row0 * H + i] = R[(i / H) * ldh + i % H];
  }

  // ---- head of the next layer: bu straight to device memory ----
  if (a.has_head) {
    const LayerParams& lp = a.head;
    layer_norm(lp, m, R, Z, ldh, rows);
    __syncthreads();
    mixer_bproj(lp, H, Z, ldh, rows, Q, a.ldq, [&](int r, int c, float v) {
      a.bu_out[(row0 + r) * a.ld_bu + c] = v;
    });
  }

  // ---- decoder ----
  if (a.dec.w)
    decode_tile(R, ldh, a.dec, H, a.d_out, a.out, a.out_type, row0, rows, Q,
                a.ldq);
}

// Steps [t0, t0 + kU) of one channel's bu halves (row stride ld, the im
// half P after the re half) into registers; steps past L are left alone.
template <int kU>
__device__ inline void fetch_steps(const float* s, int ld, int P, int L,
                                   int t0, float* re, float* im) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int t = t0 + u;
    if (t < L) {
      re[u] = s[(long long)t * ld];
      im[u] = s[(long long)t * ld + P];
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
engine_scan_pass_kernel(const __grid_constant__ ScanPass a) {
  constexpr int kU = kScanUnroll;
  const LayerParams& lp = a.lp;
  const int P = lp.p, L = a.L;
  const int groups = (P + kScanThreads - 1) / kScanThreads;
  const int b = blockIdx.x / groups;
  const int p = (blockIdx.x % groups) * kScanThreads + threadIdx.x;
  if (p >= P) return;
  const int ld = a.ld;
  float* s = a.S + (long long)b * L * ld + p;
  const float lr = lp.lam_re[p], li = lp.lam_im[p];
  float xr = a.ci_re ? a.ci_re[(long long)b * P + p] : 0.f;
  float xi = a.ci_im ? a.ci_im[(long long)b * P + p] : 0.f;
  float cr[kU], ci[kU], nr[kU], ni[kU];
  fetch_steps<kU>(s, ld, P, L, 0, cr, ci);
  // the step after which the current block ends: (t + 1) % block_t == 0
  // or t + 1 == L
  int end = min(a.block_t, L) - 1;
  for (int t0 = 0; t0 < L; t0 += kU) {
    // the next steps' loads go out before this block's dependent chain
    const bool more = t0 + kU < L;
    if (more) fetch_steps<kU>(s, ld, P, L, t0 + kU, nr, ni);
    if (t0 + kU <= end) {   // no block ends here: the chain alone
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        scan::scan_step_rn(lr, li, cr[u], ci[u], xr, xi);
        s[(long long)(t0 + u) * ld] = xr;
        s[(long long)(t0 + u) * ld + P] = xi;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int t = t0 + u;
        if (t < L) {
          scan::scan_step_rn(lr, li, cr[u], ci[u], xr, xi);
          s[(long long)t * ld] = xr;
          s[(long long)t * ld + P] = xi;
          if (t == end) {   // the block ends: the carry on the grid
            mixer_grid(lp, xr, xi, xr, xi);
            end = min(end + a.block_t, L - 1);
          }
        }
      }
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        cr[u] = nr[u];
        ci[u] = ni[u];
      }
    }
  }
  if (a.co_re) {
    a.co_re[(long long)b * P + p] = xr;
    a.co_im[(long long)b * P + p] = xi;
  }
}

// ------------------------------------------------------------------ host

// The passes the last call launched, in order, with their grids' CTAs.
struct Launched {
  const char* name;
  long long ctas;
};
constexpr int kMaxLaunches = 2 * 8 + 1;   // K6 at its most layers
static Launched g_launched[kMaxLaunches];
static int g_n_launched = 0;

inline void record_launch(const char* name, long long ctas) {
  if (g_n_launched < kMaxLaunches) g_launched[g_n_launched++] = {name, ctas};
}

// Up to `cap` names and grid sizes of the last call's passes into `names`
// and `ctas`; returns how many it launched.
inline int read_launched(const char** names, long long* ctas, int cap) {
  for (int i = 0; i < g_n_launched && i < cap; ++i) {
    names[i] = g_launched[i].name;
    ctas[i] = g_launched[i].ctas;
  }
  return g_n_launched;
}

// Bytes a row of the code tile Q needs for the integer dots of one row
// pass: its encoder's, its tail's and head's layers', its decoder's.
inline int pass_ldq(const RowPass& a) {
  const int h = a.mode.h;
  int q_w = a.enc.w && a.enc.in_mode ? a.d_in : 0;
  if (a.dec.w && a.dec.in_mode) q_w = imax(q_w, h);
  if (a.has_tail) q_w = imax(q_w, code_width(a.tail, h));
  if (a.has_head) q_w = imax(q_w, code_width(a.head, h));
  return round4(q_w);
}

inline size_t row_pass_smem(const RowPass& a) {
  return sizeof(float) * (size_t)kT *
             ((a.y_out ? 1 : 2) * round4(a.mode.h) + union_width(a)) +
         (q_in_s(a) ? 0 : 2 * (size_t)kT * a.ldq);
}

// Launch a row pass (its ldq set here) on stream st and record it.
inline cudaError_t launch_row_pass(RowPass a, cudaStream_t st) {
  a.ldq = pass_ldq(a);
  const size_t smem = row_pass_smem(a);
  cudaError_t err = cudaFuncSetAttribute(
      engine_row_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  // two CTAs an SM where they fit: the carveout all shared memory
  err = cudaFuncSetAttribute(engine_row_pass_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long grid = (a.n_rows + kT - 1) / kT;
  engine_row_pass_kernel<<<(unsigned)grid, kThreads, smem, st>>>(a);
  record_launch("engine_row_pass_kernel", grid);
  return cudaGetLastError();
}

inline cudaError_t launch_scan_pass(const ScanPass& a, cudaStream_t st) {
  const long long grid =
      (long long)a.B * ((a.lp.p + kScanThreads - 1) / kScanThreads);
  engine_scan_pass_kernel<<<(unsigned)grid, kScanThreads, 0, st>>>(a);
  record_launch("engine_scan_pass_kernel", grid);
  return cudaGetLastError();
}

}  // namespace engine
