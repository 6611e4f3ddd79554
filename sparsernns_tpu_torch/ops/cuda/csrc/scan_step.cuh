// One step of the diagonal complex recurrence, shared by every kernel that
// scans: the stand-alone scan (diag_scan.cu), the S5 mixer (fused_s5.cu) and
// the whole-layer tail kernels (layer_tail_body.cuh). The mixer's backward
// recomputes with the stand-alone scan the states that the mixer kernel
// relu'd in its forward, so both must round a step alike: the step is
// spelled out in fmaf here and no kernel contracts it its own way.

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

}  // namespace scan
