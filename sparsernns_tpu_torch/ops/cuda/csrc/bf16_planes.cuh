// Exact bf16 planes for the tensor cores, shared by K7 (block_sparse.cu)
// and the serving engine's int8 float dots (engine_body.cuh).
//
// A float32 value splits into three bf16 planes whose sum is the value
// exactly (split3); an int8 or int16 code is exact in one or two planes.
// A plane times a plane has at most 16 significant bits, exact in a
// float32 product, so an mma.sync m16n8k16 over planes with float32
// accumulators computes the float32 operands' dot with the same products
// as an fmaf chain: only the order and the rounding of the sums differ.
// ops/cuda/block_sparse.py `split_f32` is the plain mirror of split3.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16_planes {

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// f32 v as three bf16 planes h[0] + h[1] + h[2] == v: the top 8
// significant bits, the next 8, the last 8 (truncation: a rounded top
// plane would overflow at the largest finite f32); exact for |v| >= 2^-110,
// where the lowest plane still lies on bf16's grid. A non-finite v is its
// own top plane.
__device__ __forceinline__ void split3(float v, uint32_t (&h)[3]) {
  const uint32_t u = __float_as_uint(v);
  if ((u & 0x7f800000u) == 0x7f800000u) {
    h[0] = bf16_bits(v);
    h[1] = h[2] = 0u;
    return;
  }
  const float r1 = v - __uint_as_float(u & 0xffff0000u);
  const uint32_t u1 = __float_as_uint(r1);
  const float r2 = r1 - __uint_as_float(u1 & 0xffff0000u);
  h[0] = u >> 16;
  h[1] = u1 >> 16;
  h[2] = bf16_bits(r2);
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace bf16_planes
