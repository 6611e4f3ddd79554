"""Kernel K2: the whole layer after the norm, forward, in one kernel.

Replaces ``sparsernns_tpu/ops/pallas/fused_layer_train.py``
``fused_layer_tail`` in affine mode (BatchNorm folded to a per-feature
affine from its running statistics), the eval forward: per batch row

    z = x ⊙ nw + nb
    xs = scan(λ, z @ W_b)                 (in order over time, with carry)
    y = [xs_re xs_im] @ W_c + D ⊙ z       (relu on xs if relu_state)
    x1 = act(y)
    h = GLU(x1, y)                        (full / half1 / half2 / none)
    out = h + x                           (relu if layer_relu)

The CUDA source is ``csrc/layer_tail.cu``; its header note gives the bound
and the design. :func:`layer_tail` launches the kernel for CUDA tensors
and takes the plain version :func:`layer_tail_plain` only for tensors on
the CPU. The dropout masks and the backward wait for the training port.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.scan import Pair, sequential_diag_scan

GLU_KINDS = ("full", "half1", "half2", "none")
ACTS = ("gelu", "relu")

#: kernel launches made by :func:`layer_tail` in this process
launches = 0


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return torch.relu(y) if act == "relu" else F.gelu(y, approximate="tanh")


def layer_tail_plain(x, lam: Pair, w_b, w_c, d, nw, nb, o2k=None, o2b=None,
                     o1k=None, o1b=None, act: str = "gelu",
                     glu: str = "none", relu_state: bool = False,
                     layer_relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version. x: (B, L, H); w_b (H, 2P); w_c (2P, H) with
    the conj-sym factor folded in; o2k/o1k (H, H) in (in, out) layout."""
    z = x * nw + nb
    p = w_b.shape[-1] // 2
    bu = z @ w_b
    xs, _ = sequential_diag_scan(lam, (bu[..., :p], bu[..., p:]))
    if relu_state:
        xs = (torch.relu(xs[0]), torch.relu(xs[1]))
    y = torch.cat(xs, dim=-1) @ w_c + d * z
    x1 = _act(y, act)
    if glu == "none":
        h = x1
    else:
        gate = torch.sigmoid(x1 @ o2k + o2b)
        base = {"half1": x1, "half2": y}.get(glu)
        if base is None:
            base = x1 @ o1k + o1b
        h = base * gate
    out = h + x
    return torch.relu(out) if layer_relu else out


_argtypes = ([ctypes.c_void_p] * 13
             + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def _lib():
    fn = build.load("layer_tail").layer_tail_fwd
    if fn.argtypes is None:
        fn.argtypes = _argtypes
        fn.restype = ctypes.c_int
    return fn


def layer_tail_cuda(x, lam: Pair, w_b, w_c, d, nw, nb, o2k=None, o2b=None,
                    o1k=None, o1b=None, act: str = "gelu",
                    glu: str = "none", relu_state: bool = False,
                    layer_relu: bool = False) -> torch.Tensor:
    """Launch the kernel (one CTA per batch row). Same arguments as
    :func:`layer_tail_plain`; every tensor float32 on one CUDA device."""
    global launches
    if glu not in GLU_KINDS or act not in ACTS:
        raise ValueError(f"glu {glu!r} / act {act!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, H), got {tuple(x.shape)}")
    b, l, h = x.shape
    p = w_b.shape[-1] // 2
    shapes = {"x": (x, (b, l, h)), "lam_re": (lam[0], (p,)),
              "lam_im": (lam[1], (p,)), "w_b": (w_b, (h, 2 * p)),
              "w_c": (w_c, (2 * p, h)), "d": (d, (h,)), "nw": (nw, (h,)),
              "nb": (nb, (h,))}
    if glu != "none":
        shapes.update(o2k=(o2k, (h, h)), o2b=(o2b, (h,)))
    if glu == "full":
        shapes.update(o1k=(o1k, (h, h)), o1b=(o1b, (h,)))
    ptrs = {}
    for name, (t, shape) in shapes.items():
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{None if t is None else tuple(t.shape)}")
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name}: expected float32 on {x.device}, got "
                             f"{t.dtype} on {t.device}")
        t = t.contiguous()
        shapes[name] = (t, shape)
        ptrs[name] = t.data_ptr()
    out = torch.empty((b, l, h), dtype=torch.float32, device=x.device)
    if b == 0 or l == 0:
        return out
    fn = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ptrs["x"], out.data_ptr(), ptrs["nw"], ptrs["nb"], ptrs["w_b"],
             ptrs["w_c"], ptrs["d"], ptrs["lam_re"], ptrs["lam_im"],
             ptrs.get("o2k"), ptrs.get("o2b"), ptrs.get("o1k"),
             ptrs.get("o1b"), b, l, h, p, GLU_KINDS.index(glu),
             ACTS.index(act), int(relu_state), int(layer_relu), stream)
    build.check(err, "layer_tail")
    launches += 1
    return out


def layer_tail(x, lam: Pair, w_b, w_c, d, nw, nb, o2k=None, o2b=None,
               o1k=None, o1b=None, act: str = "gelu", glu: str = "none",
               relu_state: bool = False, layer_relu: bool = False
               ) -> torch.Tensor:
    """One layer's tail, (B, L, H) -> (B, L, H). CUDA tensors launch the
    kernel (or raise); CPU tensors take the plain version."""
    fn = layer_tail_cuda if x.is_cuda else layer_tail_plain
    return fn(x, lam, w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b, act=act,
              glu=glu, relu_state=relu_state, layer_relu=layer_relu)
