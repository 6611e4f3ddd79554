// One step of the diagonal complex recurrence, shared by every kernel that
// scans: the stand-alone scan (diag_scan.cu) and the whole-layer tail
// kernels (layer_tail_body.cuh), whose backward recomputes the forward's
// states and relu decisions. Both must round a step alike: the step is
// spelled out in fmaf here and no kernel contracts it its own way.
//
// The mixer kernel and the serving engine's scans (engine_body.cuh, and
// diag_scan.cu with the block requant) round every product and sum on its
// own instead (scan_step_rn), as the plain PyTorch recurrence does: a state
// that lands near a rounding tie of its frozen grid then takes the same
// code in the kernel and in the plain version, and a code that flipped at a
// block end would be carried into every later state of the channel.

#pragma once

#include <cuda_runtime.h>

namespace scan {

// x <- lam * x + bu on a complex state (xr, xi).
__device__ __forceinline__ void scan_step(float lr, float li, float bu_r,
                                          float bu_i, float& xr, float& xi) {
  const float nr = fmaf(lr, xr, fmaf(-li, xi, bu_r));
  const float ni = fmaf(lr, xi, fmaf(li, xr, bu_i));
  xr = nr;
  xi = ni;
}

// The same step without contraction: (lam * x) + bu with each product and
// sum rounded, in the order of the plain recurrence.
__device__ __forceinline__ void scan_step_rn(float lr, float li, float bu_r,
                                             float bu_i, float& xr,
                                             float& xi) {
  const float nr =
      __fadd_rn(__fsub_rn(__fmul_rn(lr, xr), __fmul_rn(li, xi)), bu_r);
  const float ni =
      __fadd_rn(__fadd_rn(__fmul_rn(lr, xi), __fmul_rn(li, xr)), bu_i);
  xr = nr;
  xi = ni;
}

}  // namespace scan
