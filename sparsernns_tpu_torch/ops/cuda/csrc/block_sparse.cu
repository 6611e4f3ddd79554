// Kernel K7: the block-sparse dense matmul over kept weight tiles:
//   y = (x @ W) * scale,  x (M, K) f32 or bf16,  y (M, N) f32,
// where W (K, N) is stored as its kept (bk, 128) tiles only (block-CSC by
// output tile: the tiles of output column tile j are data[col_ptr[j] ..
// col_ptr[j+1]), each with its input tile index blk_k), as int8, int16 or
// f32 values. All-zero tiles are neither stored nor read nor multiplied;
// an output tile with no kept tile holds the packer's zero pad block, which
// is multiplied like any tile (so an inf or NaN in x gives NaN there, as in
// the TPU kernel).
//
// Replaces the TPU kernel sparsernns_tpu/ops/pallas/block_sparse.py
// `block_sparse_matmul` (pallas_call at :175, body `_bs_kernel` :126). On
// the TPU the grid is (M tiles, kept blocks) in order: consecutive blocks of
// one output tile revisit and accumulate it in VMEM, and `is_first` zeroes
// it once.
//
// Bound: bytes, at every served shape. The (M, N) f32 output is most of
// them (23-31 MB at M = 30008, K and N of 192 or 257), then the x columns
// that some kept tile uses and the tiles (27.0 MB in all for the encoder
// 257 -> 192 at 90 % zero tiles with f32 x: 8.1 us at 3.35 TB/s). The
// products, on the tensor cores, take a few us even as nine bf16 plane
// products of f32 x with f32 tiles.
//
// Design, against that bound:
//   * Exact bf16 planes on the tensor cores (mma.sync m16n8k16, f32
//     accumulators). Each operand is staged as bf16 planes whose sum is
//     exactly the value the function multiplies:
//       f32 x: 3 planes (split3, bf16_planes.cuh), the top 8 significant
//         bits, the next 8, the last 8 (truncation: a rounded top plane
//         would overflow at the largest finite f32); exact for |x| >=
//         2^-110, where the lowest plane still lies on bf16's grid; a
//         non-finite x is its own top plane;
//       bf16 x: itself;
//       int8 tile: itself (exact); int16 tile: hi * 256 and lo (lo the
//         unsigned low byte); f32 tile: split3;
//       with bf16 x an int16 or f32 tile rounds to bf16 first, as in the
//         Pallas kernel: one plane.
//     Every plane x plane product has at most 16 significant bits, exact in
//     f32; only the order and the rounding of the sum differ from the plain
//     version's. Per 16-deep k-step, each tile plane, each x plane: one mma
//     (ops/cuda/block_sparse.py `block_sparse_matmul_planes` repeats that
//     order). The tiles' planes are made once, when the weight is packed
//     (block_sparse_planes), for each type of x; x is split as the A
//     operand is gathered from shared memory into registers.
//   * A persistent walk. An item is (row tile of 128, 64, 32 or 16 rows,
//     output tile j); items are numbered row tile by row tile, j fastest,
//     and each CTA takes a contiguous range of them (the plan,
//     ops/cuda/block_sparse.py `launch_plan`: the largest row tile that
//     still gives every SM an item, 128 rows at M = 30008 and 16 at the
//     chunk shape M = 1024; as many CTAs as the SMs hold). A CTA
//     walks its items' steps (a step: 32 rows of one kept tile's planes and
//     the x columns they multiply) through a ring of `stages` cp.async
//     stages of 16-byte copies, across item ends, so that the next item's
//     loads fly while an item's products and epilogue run; one barrier a
//     step. Only the x columns of a kept tile's input tile are read. A row
//     of x whose slice is not 16-byte aligned (K = 257) is staged from the
//     unit below it and read a few values in (its shift). Rows past M and
//     columns past K land as zeros.
//   * The epilogue scales the accumulators and stages each warp's rows
//     through shared memory, 32 columns at a time, so that every store
//     instruction writes whole 128-byte row segments: 16-byte stores where
//     N % 4 == 0 (N = 192), else 4-byte stores with a warp on 32
//     contiguous floats (N = 257, whose third output tile has one valid
//     column).
// A CTA is 8 warps over (128 rows, 128 columns), 8 x 16 rows, or 4 over
// a smaller tile: 64 rows as 4 x 16, 32 as 2 x (16 rows, 64 columns), 16
// as (16 rows, 4 x 32 columns). Each launch is recorded;
// block_sparse_launched hands the wrapper the last one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_planes.cuh"

// The packed weight as a launch takes it for one type of x
// (ops/cuda/block_sparse.py `_WeightArgs`), built once when it is packed.
struct BsWeight {
  const uint16_t* planes;  // (nnz * bk / 32, n_planes, 32, 128) bf16 bits
  const int* col_ptr;      // (n_tiles + 1)
  const int* blk_k;        // (nnz)
  int n_planes;            // of each tile slice: 1, 2 or 3
  int K, N, bk, n_tiles;
  float scale;
};

namespace {

constexpr int kBN = 128;        // output tile width: the packed tiles' bn
constexpr int kSlice = 32;      // rows of a tile (and x columns) a step
constexpr int kWPitch = 136;    // a tile plane row in halves: 128 + 8 pad
constexpr int kEpiPitch = 40;   // a warp's epilogue row: 32 floats + 8 pad

struct Record {
  int ctas, bm, stages, smem;
};
Record g_last = {0, 0, 0, 0};

// x: its planes (split3, or bf16 x itself) and the bytes of a staged row
// (9 16-byte units of f32 and pad, 5 units of bf16)
template <typename XT>
struct XType {
  static constexpr int planes = 3;
  static constexpr int row = 160;
};
template <>
struct XType<__nv_bfloat16> {
  static constexpr int planes = 1;
  static constexpr int row = 80;
};

// ------------------------------------------------------------ the planes

using bf16_planes::bf16_bits;
using bf16_planes::mma_bf16;
using bf16_planes::split3;

// The planes of a tile value, by the type of x it multiplies. One plane,
// the value rounded to bf16: exact for int8; with bf16 x an int16 or f32
// tile rounds, as in the Pallas kernel.
template <typename XT, typename WT>
struct WPlanes {
  static constexpr int n = 1;
  __device__ static void of(WT v, uint32_t (&h)[1]) {
    h[0] = bf16_bits((float)v);
  }
};
template <>
struct WPlanes<float, int16_t> {  // hi * 256 + lo, lo in 0..255
  static constexpr int n = 2;
  __device__ static void of(int16_t v, uint32_t (&h)[2]) {
    const int w = v;
    h[0] = bf16_bits((float)((w >> 8) * 256));
    h[1] = bf16_bits((float)(w & 0xff));
  }
};
template <>
struct WPlanes<float, float> {
  static constexpr int n = 3;
  __device__ static void of(float v, uint32_t (&h)[3]) { split3(v, h); }
};

// Every tile value -> its planes, slice by slice: value i of the (nnz, bk,
// 128) tiles (slice i / 4096, place i % 4096) lands in each plane p of
// that slice at (slice * n + p) * 4096 + i % 4096.
template <typename XT, typename WT>
__global__ void tile_planes_kernel(const WT* __restrict__ data,
                                   uint16_t* __restrict__ planes,
                                   long long n_values) {
  constexpr int NW = WPlanes<XT, WT>::n;
  constexpr int kSliceValues = kSlice * kBN;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_values; i += (long long)gridDim.x * blockDim.x) {
    uint32_t h[NW];
    WPlanes<XT, WT>::of(data[i], h);
    const long long base =
        i / kSliceValues * NW * kSliceValues + i % kSliceValues;
#pragma unroll
    for (int p = 0; p < NW; ++p)
      planes[base + p * kSliceValues] = (uint16_t)h[p];
  }
}

// ------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// a 16-byte cp.async; the bytes past `valid` land as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_wait_stage(int stages) {
  if (stages >= 4)
    cp_wait<2>();
  else if (stages == 3)
    cp_wait<1>();
  else
    cp_wait<0>();
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ------------------------------------------------------------ the walk

// A CTA's position in its steps: item (row tile * n_tiles + j), kept tile
// s of column j, and the 32-row slice `sub` of that tile.
struct Cursor {
  int item, end, s, s_end, sub;
};

__device__ __forceinline__ void cursor_begin(Cursor& c, const BsWeight& w) {
  if (c.item < c.end) {
    const int j = c.item % w.n_tiles;
    c.s = __ldg(w.col_ptr + j);
    c.s_end = __ldg(w.col_ptr + j + 1);
    c.sub = 0;
  }
}

__device__ __forceinline__ bool cursor_last(const Cursor& c,
                                            const BsWeight& w) {
  return c.sub + kSlice >= w.bk && c.s + 1 >= c.s_end;
}

__device__ __forceinline__ void cursor_next(Cursor& c, const BsWeight& w) {
  c.sub += kSlice;
  if (c.sub < w.bk) return;
  c.sub = 0;
  if (++c.s < c.s_end) return;
  ++c.item;
  cursor_begin(c, w);
}

// A CTA's warps: 16 rows each at a 128-row tile, else 4 (a 64-row tile
// as 4 x 16 rows, 32 as 2 x (16 rows, 64 columns), 16 as 16 rows and 4 x
// 32 columns); and the CTAs an SM holds at most (the kernel's register
// budget: 2 of 8 warps; of 4 warps, 4 with one tile plane, 3 with two, 2
// with three).
__host__ __device__ constexpr int warps_of(int bm) { return bm == 128 ? 8 : 4; }
__host__ __device__ constexpr int max_ctas_per_sm(int bm, int n_planes) {
  return bm == 128 ? 2 : n_planes == 1 ? 4 : n_planes == 2 ? 3 : 2;
}

// Bytes of a ring stage (bm staged x rows, then the slice's planes) and of
// the CTA's dynamic shared memory (the ring, then the warps' epilogues).
__host__ __device__ __forceinline__ int stage_bytes(int bm, int x_row,
                                                    int n_planes) {
  return bm * x_row + n_planes * kSlice * kWPitch * 2;
}
__host__ __device__ __forceinline__ int smem_bytes(int bm, int x_row,
                                                   int n_planes, int stages) {
  return stages * stage_bytes(bm, x_row, n_planes) +
         warps_of(bm) * 16 * kEpiPitch * 4;
}

// How far into its first staged 16-byte unit a row's slice starts.
template <typename XT>
__device__ __forceinline__ int slice_shift(int row, int K, int k0) {
  constexpr int epu = 16 / (int)sizeof(XT);
  return (row * K + k0) & (epu - 1);
}

// Issue one step's copies into ring stage `st`: the x slice (bm rows x 32
// columns from k0, in 16-byte units from the unit holding its first
// element: 8 (bf16: 4) units where every slice is aligned, else 9 (5);
// rows past M and columns past K zeroed) and the slice's planes.
template <typename XT, bool kAligned>
__device__ __forceinline__ void issue_step(unsigned char* st,
                                           const Cursor& c, const BsWeight& w,
                                           const XT* __restrict__ x, int M,
                                           int bm) {
  constexpr int esz = (int)sizeof(XT);
  constexpr int epu = 16 / esz;
  constexpr int units = kSlice / epu + (kAligned ? 0 : 1);
  constexpr int x_row = XType<XT>::row;
  const int row0 = c.item / w.n_tiles * bm;
  const int k0 = __ldg(w.blk_k + c.s) * w.bk + c.sub;
  for (int i = threadIdx.x; i < bm * units; i += blockDim.x) {
    const int r = i / units, u = i % units;
    const int row = row0 + r;
    const int e = ((row * w.K + k0) & ~(epu - 1)) + u * epu;
    const int col = e - row * w.K;  // below k0 by the shift; may be < 0
    int valid = 0;
    if (row < M && col < w.K) valid = min(16, (w.K - col) * esz);
    cp_async16(st + r * x_row + u * 16, valid ? x + e : x, valid);
  }
  const int slice = c.s * (w.bk / kSlice) + c.sub / kSlice;
  const uint16_t* src =
      w.planes + (long long)slice * w.n_planes * kSlice * kBN;
  unsigned char* wst = st + bm * x_row;
  for (int i = threadIdx.x; i < w.n_planes * kSlice * kBN / 8;
       i += blockDim.x)  // unit i: plane row i / 16, 8 values from (i % 16) * 8
    cp_async16(wst + (i / 16) * kWPitch * 2 + (i % 16) * 16, src + i * 8, 16);
}

// The A operand's planes of x rows (r, r + 8), columns (c, c + 1) and
// (c + 8, c + 9) of the staged slice: a[p][0..3] in mma order.
template <typename XT, bool kAligned>
struct Gather;
template <bool kAligned>
struct Gather<float, kAligned> {
  __device__ static void pair(const unsigned char* xs, int r, int c,
                              int shift, uint32_t (&a)[3][4], int slot) {
    const float* row =
        reinterpret_cast<const float*>(xs + r * XType<float>::row);
    float v0, v1;
    if (kAligned) {
      const float2 v = *reinterpret_cast<const float2*>(row + c);
      v0 = v.x;
      v1 = v.y;
    } else {
      v0 = row[shift + c];
      v1 = row[shift + c + 1];
    }
    uint32_t lo[3], hi[3];
    split3(v0, lo);
    split3(v1, hi);
#pragma unroll
    for (int p = 0; p < 3; ++p) a[p][slot] = lo[p] | (hi[p] << 16);
  }
};
template <bool kAligned>
struct Gather<__nv_bfloat16, kAligned> {
  __device__ static void pair(const unsigned char* xs, int r, int c,
                              int shift, uint32_t (&a)[1][4], int slot) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(
        xs + r * XType<__nv_bfloat16>::row);
    if (kAligned) {
      a[0][slot] = words[c >> 1];
    } else {
      const int h = shift + c;
      a[0][slot] =
          __funnelshift_r(words[h >> 1], words[(h >> 1) + 1], (h & 1) * 16);
    }
  }
};

template <typename XT, int NW, int BM, bool kAligned>
__global__ void __launch_bounds__(32 * warps_of(BM), max_ctas_per_sm(BM, NW))
    block_sparse_kernel(const XT* __restrict__ x, BsWeight w,
                        float* __restrict__ y, int M, int stages) {
  constexpr int NX = XType<XT>::planes;
  constexpr int WARPS_M = BM / 16;                   // 16 rows a warp
  constexpr int WARPS_N = warps_of(BM) / WARPS_M;    // warps across 128
  constexpr int WN = kBN / WARPS_N;                  // a warp's columns
  constexpr int NB = WN / 8;                         // its n8 blocks
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_size = stage_bytes(BM, XType<XT>::row, NW);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  float* epi = reinterpret_cast<float*>(smem + stages * stage_size) +
               warp * 16 * kEpiPitch;

  const long long items = (long long)((M + BM - 1) / BM) * w.n_tiles;
  Cursor ld, cp;
  ld.item = cp.item = (int)(blockIdx.x * items / gridDim.x);
  ld.end = cp.end = (int)((blockIdx.x + 1) * items / gridDim.x);
  cursor_begin(ld, w);
  cursor_begin(cp, w);
  for (int i = 0; i < stages - 1; ++i) {
    if (ld.item < ld.end) {
      issue_step<XT, kAligned>(smem + i * stage_size, ld, w, x, M, BM);
      cursor_next(ld, w);
    }
    cp_commit();
  }

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int mi = lane >> 3, mr = lane & 7;
  int stage = 0;
  while (cp.item < cp.end) {
    cp_wait_stage(stages);
    __syncthreads();  // the stage landed; every warp is done with the last
    if (ld.item < ld.end) {
      const int next = stage == 0 ? stages - 1 : stage - 1;
      issue_step<XT, kAligned>(smem + next * stage_size, ld, w, x, M, BM);
      cursor_next(ld, w);
    }
    cp_commit();
    const unsigned char* xs = smem + stage * stage_size;
    const uint16_t* planes =
        reinterpret_cast<const uint16_t*>(xs + BM * XType<XT>::row);

    // products: per 16-deep k-step, each tile plane, each x plane; a
    // warp's columns past N (the edge output tile) are skipped
    const int row0 = cp.item / w.n_tiles * BM;
    const int j = cp.item % w.n_tiles;
    const int wcol = j * kBN + wn * WN;
    const int r0 = wm * 16 + g;
    int sh0 = 0, sh1 = 0;
    if (!kAligned) {
      const int k0 = __ldg(w.blk_k + cp.s) * w.bk + cp.sub;
      sh0 = slice_shift<XT>(row0 + r0, w.K, k0);
      sh1 = slice_shift<XT>(row0 + r0 + 8, w.K, k0);
    }
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 16) {
      uint32_t a[NX][4];
      Gather<XT, kAligned>::pair(xs, r0, kk + 2 * t, sh0, a, 0);
      Gather<XT, kAligned>::pair(xs, r0 + 8, kk + 2 * t, sh1, a, 1);
      Gather<XT, kAligned>::pair(xs, r0, kk + 2 * t + 8, sh0, a, 2);
      Gather<XT, kAligned>::pair(xs, r0 + 8, kk + 2 * t + 8, sh1, a, 3);
      const uint16_t* brow = planes + (kk + mr + ((mi & 1) << 3)) * kWPitch +
                             wn * WN + ((mi >> 1) << 3);
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        if (wcol + np * 16 < w.N) {
#pragma unroll
          for (int q = 0; q < NW; ++q) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, brow + q * kSlice * kWPitch + np * 16);
#pragma unroll
            for (int p = 0; p < NX; ++p) {
              mma_bf16(acc[2 * np], a[p], b[0], b[1]);
              mma_bf16(acc[2 * np + 1], a[p], b[2], b[3]);
            }
          }
        }
      }
    }

    if (cursor_last(cp, w)) {
      // epilogue: scale, stage 32 columns of the warp's 16 rows, store
      const bool vec = (w.N & 3) == 0;
      const int rbase = row0 + wm * 16;
#pragma unroll
      for (int cc = 0; cc < NB / 4; ++cc) {
        const int col0 = wcol + cc * 32;
        if (col0 >= w.N) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float* v = acc[cc * 4 + n];
          *reinterpret_cast<float2*>(epi + g * kEpiPitch + n * 8 + 2 * t) =
              make_float2(v[0] * w.scale, v[1] * w.scale);
          *reinterpret_cast<float2*>(epi + (g + 8) * kEpiPitch + n * 8 +
                                     2 * t) =
              make_float2(v[2] * w.scale, v[3] * w.scale);
        }
        __syncwarp();
        if (vec) {
#pragma unroll
          for (int it = 0; it < 4; ++it) {
            const int r = it * 4 + lane / 8, c = (lane % 8) * 4;
            const int row = rbase + r;
            if (row < M && col0 + c < w.N)
              *reinterpret_cast<float4*>(y + (long long)row * w.N + col0 +
                                         c) =
                  *reinterpret_cast<const float4*>(epi + r * kEpiPitch + c);
          }
        } else {
          for (int r = 0; r < 16; ++r) {
            const int row = rbase + r;
            if (row < M && col0 + lane < w.N)
              y[(long long)row * w.N + col0 + lane] =
                  epi[r * kEpiPitch + lane];
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    cursor_next(cp, w);
    stage = stage + 1 == stages ? 0 : stage + 1;
  }
  cp_wait<0>();
}

template <typename XT, int NW, int BM, bool kAligned>
cudaError_t launch(const void* x, const BsWeight& w, float* y, int M,
                   int stages, int ctas, cudaStream_t st) {
  const int smem = smem_bytes(BM, XType<XT>::row, NW, stages);
  auto kernel = block_sparse_kernel<XT, NW, BM, kAligned>;
  static int set_for = 0;  // the largest dynamic size allowed so far
  if (smem > set_for) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set_for = smem;
  }
  kernel<<<ctas, 32 * warps_of(BM), smem, st>>>(static_cast<const XT*>(x), w,
                                                y, M, stages);
  g_last = {ctas, BM, stages, smem};
  return cudaGetLastError();
}

template <typename XT, int NW, int BM>
cudaError_t aligned_or_not(const void* x, int aligned, const BsWeight& w,
                           float* y, int M, int stages, int ctas,
                           cudaStream_t st) {
  return aligned ? launch<XT, NW, BM, true>(x, w, y, M, stages, ctas, st)
                 : launch<XT, NW, BM, false>(x, w, y, M, stages, ctas, st);
}

template <typename XT, int NW>
cudaError_t by_shape(const void* x, int aligned, const BsWeight& w, float* y,
                     int M, int bm, int stages, int ctas, cudaStream_t st) {
  switch (bm) {
    case 128:
      return aligned_or_not<XT, NW, 128>(x, aligned, w, y, M, stages, ctas,
                                         st);
    case 64:
      return aligned_or_not<XT, NW, 64>(x, aligned, w, y, M, stages, ctas,
                                        st);
    case 32:
      return aligned_or_not<XT, NW, 32>(x, aligned, w, y, M, stages, ctas,
                                        st);
    default:
      return aligned_or_not<XT, NW, 16>(x, aligned, w, y, M, stages, ctas,
                                        st);
  }
}

template <typename XT, typename WT>
cudaError_t planes_of(const void* data, void* planes, long long n_values,
                      cudaStream_t st) {
  const long long blocks = (n_values + 255) / 256;
  tile_planes_kernel<XT, WT>
      <<<(int)(blocks < 1024 ? blocks : 1024), 256, 0, st>>>(
          static_cast<const WT*>(data), static_cast<uint16_t*>(planes),
          n_values);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t planes_by_tile(int wtype, const void* data, void* planes,
                           long long n_values, cudaStream_t st) {
  if (wtype == 1) return planes_of<XT, int8_t>(data, planes, n_values, st);
  if (wtype == 2) return planes_of<XT, int16_t>(data, planes, n_values, st);
  return planes_of<XT, float>(data, planes, n_values, st);
}

}  // namespace

// x: (M, K) contiguous, 16-byte aligned, f32 (x_bf16 = 0) or bf16 (1);
// aligned: every row's slice starts 16-byte aligned (K * sizeof(x) % 16 ==
// 0). w: the packed weight's arguments for this type of x (planes from
// block_sparse_planes, bk a multiple of 32, col_ptr with every column
// holding at least one tile; M * max(K, N) < 2^31). y: (M, N) f32
// contiguous, 16-byte aligned, every element written. bm (128, 64, 32, 16),
// stages (2..4) and ctas from the wrapper's plan. Returns
// cudaGetLastError() after the launch.
extern "C" int block_sparse_run(const BsWeight* w, const void* x, int x_bf16,
                                int aligned, float* y, int M, int bm,
                                int stages, int ctas, void* stream) {
  const int np = w->n_planes;
  if ((bm != 128 && bm != 64 && bm != 32 && bm != 16) || stages < 2 ||
      stages > 4 ||
      ctas < 1 || w->bk % kSlice || np < 1 || np > 3 || (x_bf16 && np != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return (int)by_shape<__nv_bfloat16, 1>(x, aligned, *w, y, M, bm, stages,
                                           ctas, st);
  if (np == 1)
    return (int)by_shape<float, 1>(x, aligned, *w, y, M, bm, stages, ctas,
                                   st);
  if (np == 2)
    return (int)by_shape<float, 2>(x, aligned, *w, y, M, bm, stages, ctas,
                                   st);
  return (int)by_shape<float, 3>(x, aligned, *w, y, M, bm, stages, ctas, st);
}

// The planes of every kept tile for x of one type: data (nnz, bk, 128)
// int8 (wtype 1), int16 (2) or f32 (0) -> planes (nnz * bk / 32,
// n_planes, 32, 128) bf16, n_planes as WPlanes gives it. Returns
// cudaGetLastError() after the launch.
extern "C" int block_sparse_planes(const void* data, int wtype, int x_bf16,
                                   void* planes, long long n_values,
                                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(x_bf16 ? planes_by_tile<__nv_bfloat16>(wtype, data, planes,
                                                      n_values, st)
                      : planes_by_tile<float>(wtype, data, planes, n_values,
                                              st));
}

// Dynamic shared memory bytes of a CTA, as the launch sets it.
extern "C" int block_sparse_smem(int x_bf16, int n_planes, int bm,
                                 int stages) {
  return smem_bytes(bm, x_bf16 ? XType<__nv_bfloat16>::row : XType<float>::row,
                    n_planes, stages);
}

// The last launch: CTAs, rows a tile, stages, dynamic shared memory.
extern "C" void block_sparse_launched(int* out) {
  out[0] = g_last.ctas;
  out[1] = g_last.bm;
  out[2] = g_last.stages;
  out[3] = g_last.smem;
}
