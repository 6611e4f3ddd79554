// Block-sparse dense matmul over kept weight tiles:
//   y = (x @ W) * scale,  x (M, K) f32 or bf16,  y (M, N) f32,
// where W (K, N) is stored as its kept (bk, bn) tiles only (block-CSC by
// output tile: the tiles of output column tile j are data[col_ptr[j] ..
// col_ptr[j+1]), each with its input tile index blk_k), as int8, int16 or
// f32 values. All-zero tiles are neither stored nor read nor multiplied.
//
// Replaces the TPU kernel sparsernns_tpu/ops/pallas/block_sparse.py
// `block_sparse_matmul` (pallas_call at :175). On the TPU the grid is
// (M tiles, kept blocks) in order: consecutive blocks of one output tile
// revisit and accumulate it in VMEM, and `is_first` zeroes it once. CUDA
// blocks run in no order, so here one thread block owns one (64-row tile of
// M, output tile j) pair and walks column j's kept tiles itself through the
// per-column offsets, the sums in registers: its (rows x 128) output is
// written once, with no atomics and no zero-fill pass (a column with no
// kept tile writes zeros).
//
// Numerics: as in the Pallas kernel, a tile is cast to the type of x
// before the product (with bf16 x an f32 or int16 tile rounds to bf16; an
// int8 tile is exact), then x and the tile widen to f32 exactly and each
// bf16 x bf16 product is exact in f32, so against the TPU's bf16 dot with
// f32 accumulation only the order of the sum differs. The scale
// multiplies the finished sum; the bias and any requant stay with the
// caller, as in the JAX package.
//
// Bound at the serving shapes (M = 30008 rows, K and N of 192 or 257, 90 %
// of the (32, 128) tiles zero): bytes. The (M, N) f32 output alone is
// 23-31 MB (7-9 us at 3.35 TB/s); the kept tiles' flops are 0.5-1 GFLOP
// (8-15 us at 67 TFLOP/s f32). Design: each kept tile is staged as 32-row
// slices, the x slice (64 x 32) and the tile slice (32 x 128) in shared
// memory as f32, and each of 256 threads accumulates an 8 x 4 block of the
// output with fmaf from broadcast x reads and float4 weight reads. Tensor
// cores (wgmma on bf16 / int8) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // rows of x per thread block
constexpr int kBN = 128;       // output tile width: the packed tiles' bn
constexpr int kBK = 32;        // depth of one staged slice of a tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kTM = 8;         // output rows per thread
constexpr int kTN = 4;         // output columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A tile value in the compute type of x (round to nearest even for bf16).
template <typename XT>
__device__ __forceinline__ float as_x_type(float v) {
  return to_f32(static_cast<XT>(v));
}
template <>
__device__ __forceinline__ float as_x_type<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename WT>
struct Quad;
template <>
struct Quad<float> {
  using V = float4;
};
template <>
struct Quad<int8_t> {
  using V = char4;
};
template <>
struct Quad<int16_t> {
  using V = short4;
};

template <typename XT, typename WT>
__global__ void __launch_bounds__(kThreads) block_sparse_kernel(
    const XT* __restrict__ x, const WT* __restrict__ data,
    const int* __restrict__ col_ptr, const int* __restrict__ blk_k,
    float scale, float* __restrict__ y, int M, int K, int N, int bk) {
  __shared__ float xs[kBM][kBK];
  __shared__ __align__(16) float ws[kBK][kBN];
  const long long row0 = (long long)blockIdx.x * kBM;
  const int j = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 32;   // columns tx*4 .. tx*4+3 of the tile
  const int ty = tid / 32;   // rows ty*8 .. ty*8+7 (one warp: one ty)
  float acc[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.f;

  const int end = col_ptr[j + 1];
  for (int s = col_ptr[j]; s < end; ++s) {
    const int kt = blk_k[s];
    const WT* tile = data + (long long)s * bk * kBN;
    for (int sub = 0; sub < bk; sub += kBK) {
      const int k0 = kt * bk + sub;
      // the x slice; rows past M and columns past K (an edge tile) read 0
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const long long row = row0 + r;
        const int col = k0 + c;
        xs[r][c] = (row < M && col < K) ? to_f32(x[row * K + col]) : 0.f;
      }
      // rows sub .. sub+31 of the tile, four values a load
      for (int i = tid; i < kBK * kBN / 4; i += kThreads) {
        const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
        const typename Quad<WT>::V v =
            *reinterpret_cast<const typename Quad<WT>::V*>(
                tile + (long long)(sub + r) * kBN + c);
        *reinterpret_cast<float4*>(&ws[r][c]) = make_float4(
            as_x_type<XT>((float)v.x), as_x_type<XT>((float)v.y),
            as_x_type<XT>((float)v.z), as_x_type<XT>((float)v.w));
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 w = *reinterpret_cast<const float4*>(&ws[kk][tx * kTN]);
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          const float a = xs[ty * kTM + r][kk];
          acc[r][0] = fmaf(a, w.x, acc[r][0]);
          acc[r][1] = fmaf(a, w.y, acc[r][1]);
          acc[r][2] = fmaf(a, w.z, acc[r][2]);
          acc[r][3] = fmaf(a, w.w, acc[r][3]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
    const long long row = row0 + ty * kTM + r;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int col = j * kBN + tx * kTN + c;
      if (col < N) y[row * N + col] = acc[r][c] * scale;
    }
  }
}

template <typename XT, typename WT>
void launch(const void* x, const void* data, const int* col_ptr,
            const int* blk_k, float scale, float* y, int M, int K, int N,
            int bk, int n_tiles, cudaStream_t st) {
  const dim3 grid((M + kBM - 1) / kBM, n_tiles);
  block_sparse_kernel<XT, WT><<<grid, kThreads, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(data), col_ptr,
      blk_k, scale, y, M, K, N, bk);
}

template <typename XT>
void launch_w(int wtype, const void* x, const void* data, const int* col_ptr,
              const int* blk_k, float scale, float* y, int M, int K, int N,
              int bk, int n_tiles, cudaStream_t st) {
  if (wtype == 1) {
    launch<XT, int8_t>(x, data, col_ptr, blk_k, scale, y, M, K, N, bk,
                       n_tiles, st);
  } else if (wtype == 2) {
    launch<XT, int16_t>(x, data, col_ptr, blk_k, scale, y, M, K, N, bk,
                        n_tiles, st);
  } else {
    launch<XT, float>(x, data, col_ptr, blk_k, scale, y, M, K, N, bk,
                      n_tiles, st);
  }
}

}  // namespace

// x: (M, K) contiguous, f32 (x_bf16 = 0) or bf16 (1). data: (nnz, bk, 128)
// contiguous kept tiles, f32 (wtype 0), int8 (1) or int16 (2); bk a
// multiple of 32. col_ptr: (n_tiles + 1) int32 offsets into data per output
// tile, blk_k: (nnz) int32 input tile of each. y: (M, N) f32 contiguous,
// every element written. Returns cudaGetLastError() after the launch.
extern "C" int block_sparse_run(const void* x, int x_bf16, const void* data,
                                int wtype, const int* col_ptr,
                                const int* blk_k, float scale, float* y,
                                int M, int K, int N, int bk, int n_tiles,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16) {
    launch_w<__nv_bfloat16>(wtype, x, data, col_ptr, blk_k, scale, y, M, K,
                            N, bk, n_tiles, st);
  } else {
    launch_w<float>(wtype, x, data, col_ptr, blk_k, scale, y, M, K, N, bk,
                    n_tiles, st);
  }
  return (int)cudaGetLastError();
}
