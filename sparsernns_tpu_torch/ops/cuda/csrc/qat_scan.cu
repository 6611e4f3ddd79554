// The QAT modes of the diagonal scan (K1) and of the S5 mixer (K4a): the
// scan with in-scan activation fake-quant over time blocks of t rows, L
// padded with zero rows to a multiple of t (qat_scan.cuh has the numerics
// and the kernels).
//
// Replaces the TPU kernels sparsernns_tpu/ops/pallas/scan_kernel.py
// `pallas_diag_scan` (pallas_call at :494) with `qat_bits`, in both
// directions, with a carry (forward) and with `block_requant` (both
// directions: the reverse scan walks the flipped sequence, so its blocks,
// and the carries it puts on the grid, align from the end), and
// sparsernns_tpu/ops/pallas/fused_s5.py `fused_s5_apply` (pallas_call at
// :258) with `qat_bits`, `qat_state_scale`, int8 / int16 weights with
// per-half scales and `block_requant`. On the TPU the grid walks a row's
// time blocks in order, each block resident in VMEM, the carry in scratch,
// and the wrapper builds the lambda tables with XLA ops.
//
// Here a block (t x 2P floats: 512 KB at t = 512, 1 MB at t = 1024, P =
// 128) is more than one CTA's 227 KB of shared memory, but the doubling
// passes couple rows only within a channel. So a block is split by
// channel over the CTAs of a thread-block cluster (cpc channels a CTA, a
// power of two; the wrapper's plan picks it: 64 KB of a block a CTA, two
// CTAs an SM, so 16 channels and a cluster of 8 at t = 512, 8 and a
// cluster of 16 at t = 1024, up to t = 3592 at 227 KB a CTA), each CTA
// holding all t rows of its channels in its own shared memory; only the
// block maxima of a per-block scale cross CTAs, through distributed shared
// memory. A mode is:
//
//   K1    tables (a cluster of 8 CTAs: lam^(2^k) by squaring, lam^(r+1)
//         in polar form, each fake-quantized; it also zeroes the scan's
//         counters), then
//         the scan: one cluster per (batch row, block), passes and carry
//         fold in shared memory, the carry of block j - 1 read from the
//         cluster that published it (look-back), states out (unflipped,
//         unpadded). 2 launches.
//   K4a   tables; the serving layer's head row pass (engine_passes.cuh: u
//         -> bu into a (B * L, 2P) scratch over tiles of 32 flattened
//         rows, bu = (u @ W_b) * per-half scale, each output one fmaf
//         chain in ascending k); the scan over that scratch (the padding
//         rows only in shared memory), the states back in place; the tail
//         row pass (relu, the C-side scale, the C-projection + d * u). 4
//         launches.
//
// Bound. K1: bytes (bu read once, the states written once: 61.5 MB at
// B = 8, L = 3751, P = 128, 0.018 ms); K4a: operations, the two
// projections (5.9 GFLOP at B = 8, L = 3751, H = 192, P = 128) plus the
// passes, 0.093 ms at the f32 peak. The scan moves no block through device
// memory: a CTA reads its slice of bu once and writes its states once; the
// tables (1 MB at t = 1024) stay in L2. What remains is the passes'
// arithmetic (two IEEE divisions an element a pass, num_passes = 9-10
// passes) over B * ceil(L / t) clusters, and the in-order chain of each
// row's carries (one fold, one cluster maximum and one publish a block).
//
// Each launch is recorded with its grid, cluster and shared memory;
// qat_scan_launched hands the wrapper the record of the last call.

#include "engine_passes.cuh"
#include "qat_scan.cuh"

namespace {

struct Launch {
  const char* name;
  long long ctas;
  int cluster;
  int smem;
};
constexpr int kMaxRecord = 8;
Launch g_record[kMaxRecord];
int g_n_record = 0;

void record(const char* name, long long ctas, int cluster, int smem) {
  if (g_n_record < kMaxRecord)
    g_record[g_n_record++] = {name, ctas, cluster, smem};
}

int cpc_log2(int cpc) {
  int l = 0;
  while ((1 << l) < cpc) ++l;
  return l;
}

cudaError_t launch_tables(const float* lam_re, const float* lam_im,
                          float* tables, int* sync, int n_sync, int P, int t,
                          int num_passes, int a_bits, cudaStream_t st) {
  qat::TableArgs a = {};
  a.lam_re = lam_re;
  a.lam_im = lam_im;
  a.pow_re = tables;
  a.pow_im = tables + (size_t)num_passes * P;
  a.ct_re = tables + 2 * (size_t)num_passes * P;
  a.ct_im = a.ct_re + (size_t)t * P;
  a.sync = sync;
  a.n_sync = n_sync;
  a.P = P;
  a.t = t;
  a.num_passes = num_passes;
  a.ga = qat::make_grid(a_bits);
  const size_t smem = sizeof(float) * 4 * (size_t)P;
  cudaError_t err = cudaFuncSetAttribute(
      qat::qat_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  qat::qat_tables_kernel<<<qat::kTableCluster, qat::kTableThreads, smem,
                           st>>>(a);
  record("qat_tables_kernel", qat::kTableCluster, qat::kTableCluster,
         (int)smem);
  return cudaGetLastError();
}

// The launch configuration of the scan over `n_clusters` clusters of
// `cluster` CTAs; `attr` must outlive the config.
template <bool kMixer>
cudaError_t scan_config(int n_clusters, int cluster, size_t smem,
                        cudaStream_t st, cudaLaunchConfig_t* cfg,
                        cudaLaunchAttribute* attr) {
  auto kernel = qat::qat_scan_kernel<kMixer>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (cluster > qat::kPortableCluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = {};
  cfg->gridDim = dim3((unsigned)(n_clusters * cluster));
  cfg->blockDim = dim3(qat::kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The scan over B * n_blocks clusters of ceil(P / cpc) CTAs.
template <bool kMixer>
cudaError_t launch_scan(qat::ScanArgs a, int cpc, cudaStream_t st) {
  const int cluster = (a.P + cpc - 1) / cpc;
  if (cpc > 256 || (cpc & (cpc - 1)) || cluster > qat::kMaxCluster)
    return cudaErrorInvalidValue;
  a.cpc_log2 = cpc_log2(cpc);
  const int n_clusters = a.B * a.n_blocks;
  const size_t smem = qat::scan_smem(a.t, a.P, cpc);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      scan_config<kMixer>(n_clusters, cluster, smem, st, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, qat::qat_scan_kernel<kMixer>, a);
  record(kMixer ? "qat_scan_kernel<mixer>" : "qat_scan_kernel<scan>",
         (long long)n_clusters * cluster, cluster, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

void fill_common(qat::ScanArgs& a, float* tables, int num_passes,
                 float* cbuf, int* sync, int B, int L, int P, int t,
                 int act_bits, float rq_re, float rq_im, int rq_bits) {
  a.pow_re = tables;
  a.pow_im = tables + (size_t)num_passes * P;
  a.ct_re = tables + 2 * (size_t)num_passes * P;
  a.ct_im = a.ct_re + (size_t)t * P;
  a.cbuf = cbuf;
  a.sync = sync;
  a.B = B;
  a.L = L;
  a.P = P;
  a.t = t;
  a.n_blocks = (L + t - 1) / t;
  a.num_passes = num_passes;
  a.g = qat::make_grid(act_bits);
  a.rq = qat::make_requant(rq_re, rq_im, rq_bits);
}

}  // namespace

// K1 in its QAT mode. bu_re/bu_im: (B, L, P) views with element strides
// (sb, st, 1); lam (P); c_re/c_im: (B, P) contiguous or null (forward only:
// the caller refuses a carry with reverse); tables: 2 (num_passes + t) P
// floats (pow re, pow im, ctab re, ctab im), written by the tables kernel;
// cbuf: (B, ceil(L / t), 2P) floats; sync: 1 + B * ceil(L / t) ints;
// out_re/out_im: (B, L, P) contiguous. cpc: channels a CTA (a power of two
// up to 256; the cluster is ceil(P / cpc) CTAs). a_bits 0 or >= 32: no
// fake-quant of the tables; act_bits >= 32: none of the states. rq_bits 0:
// no block requant, else the states on the frozen grid (rq_re, rq_im,
// rq_bits) after their fake-quant (either direction). Returns the first
// launch error.
extern "C" int qat_scan_run(
    const float* bu_re, const float* bu_im, long long sb, long long st,
    const float* lam_re, const float* lam_im, const float* c_re,
    const float* c_im, float* tables, int num_passes, float* cbuf,
    int* sync, float* out_re, float* out_im, int B, int L, int P, int t,
    int cpc, int reverse, int a_bits, int act_bits, float rq_re,
    float rq_im, int rq_bits, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  g_n_record = 0;
  const int nb = (L + t - 1) / t;
  cudaError_t err = launch_tables(lam_re, lam_im, tables, sync, 1 + B * nb,
                                  P, t, num_passes, a_bits, s);
  if (err != cudaSuccess) return (int)err;
  qat::ScanArgs a = {};
  a.bu_re = bu_re;
  a.bu_im = bu_im;
  a.sb = sb;
  a.st = st;
  a.lam_re = lam_re;
  a.lam_im = lam_im;
  a.ci_re = c_re;
  a.ci_im = c_im;
  a.out_re = out_re;
  a.out_im = out_im;
  a.reverse = reverse;
  fill_common(a, tables, num_passes, cbuf, sync, B, L, P, t, act_bits,
              rq_re, rq_im, rq_bits);
  return (int)launch_scan<false>(a, cpc, s);
}

// K4a in its QAT mode. u: (B, L, H) f32; y: (B, L, H) f32. mixer: lam, d,
// W_b (H, 2P) and W_c (2P, H) (int8 / int16 / f32) with their per-half
// scales (1 for float weights; W_c's with the conj-sym factor), no state
// grid in the struct (the scan requantizes). amax: a device scalar, the
// global state absmax, or null for per-block scales. tables, cbuf, sync,
// cpc, the bits and the requant as for qat_scan_run; bu: (B * L, 2P)
// scratch. Returns the first launch error.
extern "C" int fused_s5_qat_run(
    const float* u, float* y, const engine::LayerParams* mixer,
    int relu_state, const float* amax, float* tables, int num_passes,
    float* cbuf, int* sync, float* bu, int B, int L, int H, int t, int cpc,
    int a_bits, int act_bits, float rq_re, float rq_im, int rq_bits,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  g_n_record = 0;
  const int P = mixer->p;
  const int nb = (L + t - 1) / t;
  cudaError_t err = launch_tables(mixer->lam_re, mixer->lam_im, tables, sync,
                                  1 + B * nb, P, t, num_passes, a_bits, s);
  if (err != cudaSuccess) return (int)err;
  engine::RowPass base = {};
  base.mode.h = H;
  base.mode.glu = engine::kNone;
  base.mode.relu_state = relu_state;
  base.n_rows = (long long)B * L;
  base.ld_bu = 2 * P;
  base.ldp = engine::round4(base.ld_bu);
  base.in = u;
  base.in_type = engine::kIoF32;
  base.in_scale = 1.f;
  const long long row_ctas = (base.n_rows + engine::kT - 1) / engine::kT;
  // ---- u -> bu ----
  engine::RowPass head = base;
  head.has_head = 1;
  head.head = *mixer;
  head.bu_out = bu;
  if ((err = engine::launch_row_pass(head, s)) != cudaSuccess)
    return (int)err;
  head.ldq = engine::pass_ldq(head);
  record("engine_row_pass_kernel", row_ctas, 1,
         (int)engine::row_pass_smem(head));
  // ---- the QAT scan over bu, the states in place ----
  qat::ScanArgs a = {};
  a.io = bu;
  a.ld = 2 * P;
  a.gmax = amax;
  fill_common(a, tables, num_passes, cbuf, sync, B, L, P, t, act_bits,
              rq_re, rq_im, rq_bits);
  if ((err = launch_scan<true>(a, cpc, s)) != cudaSuccess) return (int)err;
  // ---- the states and u -> y ----
  engine::RowPass tail = base;
  tail.has_tail = 1;
  tail.tail = *mixer;
  tail.s_in = bu;
  tail.y_out = y;
  if ((err = engine::launch_row_pass(tail, s)) != cudaSuccess)
    return (int)err;
  tail.ldq = engine::pass_ldq(tail);
  record("engine_row_pass_kernel", row_ctas, 1,
         (int)engine::row_pass_smem(tail));
  return 0;
}

// The tables kernel alone (for holding it against the PyTorch ops): lam
// (P); tables: 2 (num_passes + t) P floats; sync: n_sync ints, zeroed.
extern "C" int qat_tables_run(const float* lam_re, const float* lam_im,
                              float* tables, int* sync, int n_sync, int P,
                              int t, int num_passes, int a_bits,
                              void* stream) {
  g_n_record = 0;
  return (int)launch_tables(lam_re, lam_im, tables, sync, n_sync, P, t,
                            num_passes, a_bits, (cudaStream_t)stream);
}

// The launches of the last call, in order: up to `cap` kernel names, CTAs,
// cluster sizes and dynamic shared memory; returns how many it made.
extern "C" int qat_scan_launched(const char** names, long long* ctas,
                                 int* clusters, int* smem, int cap) {
  for (int i = 0; i < g_n_record && i < cap; ++i) {
    names[i] = g_record[i].name;
    ctas[i] = g_record[i].ctas;
    clusters[i] = g_record[i].cluster;
    smem[i] = g_record[i].smem;
  }
  return g_n_record;
}

// The most clusters of the scan (t rows, P channels, cpc a CTA) that the
// card keeps resident at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int qat_scan_max_clusters(int t, int P, int cpc, int mixer,
                                     int* out) {
  const int cluster = (P + cpc - 1) / cpc;
  const size_t smem = qat::scan_smem(t, P, cpc);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (mixer) {
    err = scan_config<true>(1, cluster, smem, 0, &cfg, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          out, qat::qat_scan_kernel<true>, &cfg);
  } else {
    err = scan_config<false>(1, cluster, smem, 0, &cfg, &attr);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          out, qat::qat_scan_kernel<false>, &cfg);
  }
  return (int)err;
}
