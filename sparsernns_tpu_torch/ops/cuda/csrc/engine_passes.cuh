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
// product and requant is the same device function of engine_body.cuh on
// the same 32-row tiles of the flattened stream: an int8 float dot with
// the engine's fragments on the tensor cores over exact bf16 planes, each
// output of any other float dot an fmaf chain in ascending k from 0,
// integer dots exact, the scan steps
// without contraction; a row's result does not depend on its place in the
// tile. So K6 equals the K5 stack bit for bit, the per-op route's mixer
// rounds as the stack does, DP equals one rank, and K5b / K4b over chunks
// of whole blocks equal one call.
//
// Bound of a middle row pass on the H100 at the flagship (H = 192, P =
// 128, B = 32, L = 3751: 120 032 rows): 3.5 KB a row of device memory (the
// stream read and written, the states read, bu written; float32), 0.42 GB,
// 0.13 ms at 3.35 TB/s; against 0.27 MFLOP a row of the network's products,
// 0.81 M as three-plane tensor-core operations, 97 G a pass, 0.10 ms at
// 989 TFLOP/s bf16. So bytes and operations bound it alike near 0.13 ms,
// where the fmaf tiles could not go below 0.49 ms (67 TFLOP/s f32). The
// design keeps the tile and its shared memory (every width the fmaf tiles
// took still runs) and feeds the tensor cores from it: each warp splits
// its A fragment once a k-step for 64 columns, the codes come from L2 in
// 32-byte lanes already in mma's B layout (engine_layer.py
// `mma_fragments`, made once a weight when the engine packs it), the
// stream and states tiles land as 16-byte async copies all in flight at
// once, and the element loops go a warp to a row without index divides.
// The pass still runs near 1 ms on the card (PERF.md): the products' loop,
// not the bytes, sets its pace. A 64-row tile that stages a dense's
// fragments in shared memory for all its rows does not fit: its f32 tiles
// alone take 208 KB of the 227 KB at the flagship (104 KB at 32 rows), one
// dense's bf16 fragments 72-96 KB, and at H = 520 the 32-row tiles already
// take all of it; serving the fragments from L1 instead of L2 saved at
// most 0.04 ms a product on the card.
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

// The stages of a row pass, in the kernel's order: the one account that
// the kernel's flow and its launch record (pass_dots) both read.
struct PassStages {
  bool enc;      // the encoder dense on the tile's input
  bool tail;     // a layer's tail: its states and C-projection
  bool finish;   // then the layer after its mixer (activation, GLU denses)
  bool head;     // the next layer's norm and B-projection
  bool dec;      // the decoder dense
};

__host__ __device__ inline PassStages pass_stages(const RowPass& a) {
  // a pass that stores y (the mixer alone) or the layer's codes (the last
  // pass of K5) ends with its tail
  const bool ends = a.has_tail && (a.y_out || a.codes_out);
  PassStages st;
  st.enc = a.enc.w != nullptr;
  st.tail = a.has_tail;
  st.finish = a.has_tail && !a.y_out;
  st.head = a.has_head && !ends;
  st.dec = a.dec.w != nullptr && !ends;
  return st;
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
  const long long row0 = (long long)blockIdx.x * kT;
  const int rows = (int)min((long long)kT, a.n_rows - row0);
  const PassStages st = pass_stages(a);

  // ---- the tile's stream values: the encoder, or the stream as stored.
  // A float32 stream and a tail's raw states (the float C-projection's:
  // the integer one keeps its codes in Q, which may lie in S) go as
  // 16-byte async copies, all in flight at once. ----
  const bool in_async = !st.enc && a.in_type == kIoF32 &&
                        a.in_scale == 1.f &&
                        rows_async_ok(a.in, H, H);
  const bool s_async = st.tail && !a.tail.st_mode &&
                       rows_async_ok(a.s_in, a.ld_bu, 2 * a.tail.p);
  if (in_async)
    rows_async(R, ldh, static_cast<const float*>(a.in) + row0 * H, H, H,
               rows);
  if (s_async)
    rows_async(S, a.ldp, a.s_in + row0 * a.ld_bu, a.ld_bu, 2 * a.tail.p,
               rows);
  if (st.enc) {
    const int ldx = round4(a.d_in);
    load_tile(X, ldx, a.in, a.in_type, row0, a.d_in, rows, 1.f);
    __syncthreads();
    encode_tile(X, ldx, a.enc, a.d_in, m, R, ldh, rows, Q, a.ldq);
  } else if (!in_async) {
    load_tile(R, ldh, a.in, a.in_type, row0, H, rows, a.in_scale);
  }
  if (in_async || s_async) cp_async_wait();
  __syncthreads();

  // ---- tail of a layer: its output h replaces R ----
  if (st.tail) {
    const LayerParams& lp = a.tail;
    const int P = lp.p;
    layer_norm(lp, m, R, Z, ldh, rows);
    // the states as the C-projection reads them: floats in S, or with
    // state16 their codes in Q (quant_tile's arithmetic)
    const int p4 = round4(P);
    for_tile(rows, P, [&](int r, int p) {
      const float* x = s_async ? S + r * a.ldp + p
                               : a.s_in + (row0 + r) * a.ld_bu + p;
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
    });
    __syncthreads();
    if (lp.ut_mode) {   // the D term's operand: z on the quant_ut grid
      const float qmax = grid_max(lp.ut_bits);
      for_tile(rows, H, [&](int r, int c) {
        float* z = Z + r * ldh + c;
        *z = __fmul_rn(quant_code(*z, lp.ut_s, -qmax - 1.f, qmax), lp.ut_s);
      });
      __syncthreads();
    }
    mixer_cproj(lp, H, Z, Y, S, ldh, a.ldp, rows, Q, a.ldq);
    __syncthreads();
    if (!st.finish) {   // the mixer alone: y is the result
      for_tile(rows, H, [&](int r, int c) {
        a.y_out[(row0 + r) * H + c] = Y[r * ldh + c];
      });
      return;
    }
    layer_finish(lp, m, R, Z, Y, ldh, rows, Q, a.ldq);
    if (a.codes_out) {   // the layer's stream as stored: the last pass
      for_tile(rows, H, [&](int r, int c) {
        const float h = R[r * ldh + c];
        store_io(a.out, (row0 + r) * H + c, a.out_type,
                 lp.has_rq ? quant_code(h, lp.rq_s, lp.rq_min, lp.rq_max)
                           : h);
      });
      return;
    }
    for_tile(rows, H, [&](int r, int c) {
      float* v = R + r * ldh + c;
      *v = stream_value(*v, lp, m.act_bf16);
    });
    __syncthreads();
  }

  // ---- the stream for the next pass (in place of the rows read) ----
  if (a.stream_out) {
    for_tile(rows, H, [&](int r, int c) {
      a.stream_out[(row0 + r) * H + c] = R[r * ldh + c];
    });
  }

  // ---- head of the next layer: bu straight to device memory ----
  if (st.head) {
    const LayerParams& lp = a.head;
    layer_norm(lp, m, R, Z, ldh, rows);
    __syncthreads();
    mixer_bproj(lp, H, Z, ldh, rows, Q, a.ldq, [&](int r, int c, float v) {
      a.bu_out[(row0 + r) * a.ld_bu + c] = v;
    });
  }

  // ---- decoder ----
  if (st.dec)
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

// The passes the last call launched, in order, with their grids' CTAs
// and, for a row pass, how many of its dense products ran on the tensor
// cores and how many as fmaf tiles (integer dots are neither).
struct Launched {
  const char* name;
  long long ctas;
  int mma, fmaf;
};
constexpr int kMaxLaunches = 2 * 8 + 1;   // K6 at its most layers
static Launched g_launched[kMaxLaunches];
static int g_n_launched = 0;

inline void record_launch(const char* name, long long ctas, int mma = 0,
                          int fmaf = 0) {
  if (g_n_launched < kMaxLaunches)
    g_launched[g_n_launched++] = {name, ctas, mma, fmaf};
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

// The same passes' dense products on the tensor cores and as fmaf tiles.
inline int read_launched_dots(int* mma, int* fmaf, int cap) {
  for (int i = 0; i < g_n_launched && i < cap; ++i) {
    mma[i] = g_launched[i].mma;
    fmaf[i] = g_launched[i].fmaf;
  }
  return g_n_launched;
}

// The float-dot dense products a row pass runs (its stages, pass_stages),
// by where tile_matmul puts them (dot_on_tensor_cores): the encoder, the
// tail's C-projection, value and gate denses, the head's B-projection,
// the decoder; each float where the device function that runs it takes
// its float dot.
inline void pass_dots(const RowPass& a, int* mma, int* fmaf) {
  const PassStages st = pass_stages(a);
  *mma = *fmaf = 0;
  auto add = [&](bool float_dot, const DenseW& w) {
    if (float_dot) ++*(dot_on_tensor_cores(w) ? mma : fmaf);
  };
  if (st.enc) add(a.enc.in_mode == kDotFloat, a.enc);
  if (st.tail) add(!a.tail.st_mode, a.tail.wc);
  if (st.finish && a.mode.glu == kFull)
    add(a.tail.out1.in_mode == kDotFloat, a.tail.out1);
  if (st.finish && a.mode.glu != kNone)
    add(a.tail.out2.in_mode == kDotFloat, a.tail.out2);
  if (st.head) add(!a.head.ut_mode, a.head.wb);
  if (st.dec) add(a.dec.in_mode == kDotFloat, a.dec);
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
  int mma, fmaf;
  pass_dots(a, &mma, &fmaf);
  record_launch("engine_row_pass_kernel", grid, mma, fmaf);
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
