"""Kernel K2: the whole layer after the norm, forward, as passes over the
card.

Replaces ``sparsernns_tpu/ops/pallas/fused_layer_train.py``
``fused_layer_tail``, the eval and the training forward, in its two modes:
affine (``skip`` None: ``x`` is the raw layer input and BatchNorm folds to
the per-feature affine ``nw``, ``nb`` from its running or batch statistics)
and non-affine (``x`` is the normed ``z`` of a LayerNorm, ``skip`` the raw
input, ``nw = nb = None``). Per batch row

    z, res = x ⊙ nw + nb, x               (affine)  |  x, skip  (non-affine)
    xs = scan(λ, z @ W_b)                 (in order over time, with carry)
    y = [xs_re xs_im] @ W_c + D ⊙ z       (relu on xs if relu_state)
    x1 = act(y) ⊙ m1                      (dropout mask, constant in time)
    h = GLU(x1, y) ⊙ m2                   (full / half1 / half2 / none)
    out = h + res                         (relu if layer_relu)

``m1``, ``m2`` are (B, 1, H) float32 masks already scaled by 1/keep, or
None (eval). The streams (``x``, ``skip`` and the output) are float32 or
bfloat16, one dtype for all; a bf16 stream is computed on in f32 and the
output rounds once to bf16, as the JAX kernel stores
``o.astype(out_ref.dtype)``. Weights, masks and the affine are float32.
The CUDA source is ``csrc/layer_tail.cu``; its header note gives the
bound and the design: K3a's B-projection pass and scan (the states of every
row into scratch), then a tail pass over tiles of 64 rows of the flattened
B * L stream. :func:`launched` reads back the kernels and grids of the
last call on the card. :func:`layer_tail` launches the kernels for
CUDA tensors and takes the plain version :func:`layer_tail_plain` only for
tensors on the CPU. :class:`LayerTailFn` is the differentiable form (the
counterpart of ``fused_layer_tail_diff``): its forward saves only its
inputs and its backward is ``ops/cuda/layer_tail_bwd.py``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.scan import Pair, sequential_diag_scan
from sparsernns_tpu_torch.utils.trace import count, traced

GLU_KINDS = ("full", "half1", "half2", "none")
ACTS = ("gelu", "relu")
#: dtypes of the (B, L, H) streams that the tail kernels read and write
STREAM_DTYPES = (torch.float32, torch.bfloat16)

#: the passes of one call, as the CUDA source names its kernels
BPROJ_PASS = "tail_hist_bproj_kernel"
SCAN_PASS = "tail_hist_scan_kernel"
ROW_PASS = "layer_tail_row_kernel"
#: what the kernel's entry returns where the tail pass's x1 tile does not
#: fit in the card's shared memory (``kTooWide`` in the CUDA source)
_TOO_WIDE = -1


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return torch.relu(y) if act == "relu" else F.gelu(y, approximate="tanh")


def check_mode(nw, nb, skip) -> None:
    """Affine mode takes ``nw`` and ``nb`` and no ``skip``; non-affine mode
    takes ``skip`` and neither of the two."""
    if skip is None and (nw is None or nb is None):
        raise ValueError("affine mode (skip None) takes nw and nb")
    if skip is not None and (nw is not None or nb is not None):
        raise ValueError("non-affine mode (skip given) takes no nw / nb: x "
                         "is the normed stream")


def norm_and_residual(x, nw, nb, skip):
    """(z, res) in float32: ``(x ⊙ nw + nb, x)`` in affine mode, ``(x,
    skip)`` in non-affine mode."""
    check_mode(nw, nb, skip)
    xf = x.float()
    if skip is None:
        return xf * nw + nb, xf
    return xf, skip.float()


def layer_tail_plain(x, lam: Pair, w_b, w_c, d, nw, nb, o2k=None, o2b=None,
                     o1k=None, o1b=None, act: str = "gelu",
                     glu: str = "none", relu_state: bool = False,
                     layer_relu: bool = False, m1=None, m2=None, skip=None
                     ) -> torch.Tensor:
    """Plain PyTorch version. x: (B, L, H), the raw input (affine mode) or
    the normed z with ``skip`` the residual (non-affine mode); w_b (H, 2P);
    w_c (2P, H) with the conj-sym factor folded in; o2k/o1k (H, H) in (in,
    out) layout; m1/m2 (B, 1, H) dropout masks or None. Computes in f32 and
    returns the stream's dtype."""
    z, res = norm_and_residual(x, nw, nb, skip)
    p = w_b.shape[-1] // 2
    bu = z @ w_b
    xs, _ = sequential_diag_scan(lam, (bu[..., :p], bu[..., p:]))
    if relu_state:
        xs = (torch.relu(xs[0]), torch.relu(xs[1]))
    y = torch.cat(xs, dim=-1) @ w_c + d * z
    x1 = _act(y, act)
    if m1 is not None:
        x1 = x1 * m1
    if glu == "none":
        h = x1
    else:
        gate = torch.sigmoid(x1 @ o2k + o2b)
        base = {"half1": x1, "half2": y}.get(glu)
        if base is None:
            base = x1 @ o1k + o1b
        h = base * gate
        if m2 is not None:
            h = h * m2
    out = h + res
    if layer_relu:
        out = torch.relu(out)
    return out.to(x.dtype)


_argtypes = ([ctypes.c_void_p] * 17
             + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def launched() -> List[Tuple[str, int]]:
    """(kernel, CTAs) of every pass that the last K2 call launched on the
    card, in order, as the CUDA source recorded them at the launch."""
    fn = build.entry("layer_tail", "layer_tail_fwd_launched",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
    cap = 16
    names = (ctypes.c_char_p * cap)()
    ctas = (ctypes.c_longlong * cap)()
    n = fn(names, ctas, cap)
    return [(names[i].decode(), ctas[i]) for i in range(min(n, cap))]


def check_tensors(shapes, device, streams=()) -> Dict[str, torch.Tensor]:
    """``shapes``: name -> (tensor, expected shape). Every tensor must have
    its shape and lie on ``device``; the tensors named in ``streams`` share
    one dtype of :data:`STREAM_DTYPES`, every other one is float32. Returns
    them detached and contiguous."""
    out = {}
    stream_dtype = None
    for name, (t, shape) in shapes.items():
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{None if t is None else tuple(t.shape)}")
        want = "float32"
        ok = t.dtype == torch.float32
        if name in streams:
            stream_dtype = stream_dtype or t.dtype
            want = (f"{stream_dtype} (float32 or bfloat16, as every "
                    "stream)")
            ok = t.dtype in STREAM_DTYPES and t.dtype == stream_dtype
        if not ok or t.device != device:
            raise ValueError(f"{name}: expected {want} on {device}, got "
                             f"{t.dtype} on {t.device}")
        out[name] = t.detach().contiguous()
    return out


def checked_operands(x, lam: Pair, w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b,
                     m1, m2, act: str, glu: str, skip=None, **more
                     ) -> Dict[str, torch.Tensor]:
    """The kernels' operands by name, each checked for shape, dtype (the
    streams float32 or bfloat16, one dtype for all; the rest float32) and
    the device of ``x``, and made contiguous. Operands that the mode or the
    GLU variant does not use, and masks that are None, are left out (the
    kernels take a null pointer for them). ``more`` adds (B, L, H) streams
    (the backward's cotangent)."""
    if glu not in GLU_KINDS or act not in ACTS:
        raise ValueError(f"glu {glu!r} / act {act!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, H), got {tuple(x.shape)}")
    check_mode(nw, nb, skip)
    b, l, h = x.shape
    p = w_b.shape[-1] // 2
    shapes = {"x": (x, (b, l, h)), "lam_re": (lam[0], (p,)),
              "lam_im": (lam[1], (p,)), "w_b": (w_b, (h, 2 * p)),
              "w_c": (w_c, (2 * p, h)), "d": (d, (h,))}
    if skip is None:
        shapes.update(nw=(nw, (h,)), nb=(nb, (h,)))
    else:
        shapes["skip"] = (skip, (b, l, h))
    shapes.update({k: (v, (b, l, h)) for k, v in more.items()})
    if glu != "none":
        shapes.update(o2k=(o2k, (h, h)), o2b=(o2b, (h,)))
    if glu == "full":
        shapes.update(o1k=(o1k, (h, h)), o1b=(o1b, (h,)))
    if m1 is not None:
        shapes["m1"] = (m1, (b, 1, h))
    if m2 is not None:
        if glu == "none":
            raise ValueError("m2 masks the gated product: glu 'none' has "
                             "none")
        shapes["m2"] = (m2, (b, 1, h))
    return check_tensors(shapes, x.device, ("x", "skip", *more))


def data_ptr(ops: Dict[str, torch.Tensor], name: str) -> Optional[int]:
    t = ops.get(name)
    return None if t is None else t.data_ptr()


@traced("kernel.layer_tail")
def layer_tail_cuda(x, lam: Pair, w_b, w_c, d, nw, nb, o2k=None, o2b=None,
                    o1k=None, o1b=None, act: str = "gelu",
                    glu: str = "none", relu_state: bool = False,
                    layer_relu: bool = False, m1=None, m2=None, skip=None
                    ) -> torch.Tensor:
    """Enqueue the three passes. Same arguments as
    :func:`layer_tail_plain`; every tensor on one CUDA device, the streams
    float32 or bfloat16, the rest float32. With a GLU the tail pass keeps
    64 rows of x1 in shared memory: H up to 872 on an H100; a wider layer
    raises ValueError."""
    ops = checked_operands(x, lam, w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b,
                           m1, m2, act, glu, skip=skip)
    b, l, h = x.shape
    p = w_b.shape[-1] // 2
    out = torch.empty((b, l, h), dtype=x.dtype, device=x.device)
    if b == 0 or l == 0:
        return out
    fn = build.entry("layer_tail", "layer_tail_fwd", _argtypes)
    # S: bu, then the raw states [re | im] in place
    states = torch.empty((b * l, 2 * p), dtype=torch.float32,
                         device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptr = lambda name: data_ptr(ops, name)  # noqa: E731
    err = fn(ptr("x"), ptr("skip"), out.data_ptr(), ptr("nw"), ptr("nb"),
             ptr("w_b"), ptr("w_c"), ptr("d"), ptr("lam_re"), ptr("lam_im"),
             ptr("o2k"), ptr("o2b"), ptr("o1k"), ptr("o1b"), ptr("m1"),
             ptr("m2"), states.data_ptr(), b, l, h, p, GLU_KINDS.index(glu),
             ACTS.index(act), int(relu_state), int(layer_relu),
             int(x.dtype == torch.bfloat16), stream)
    if err == _TOO_WIDE:
        raise ValueError(f"H={h}: 64 rows of x1 do not fit in the shared "
                         "memory the card gives a block")
    build.check(err, "layer_tail")
    count("layer_tail_train")
    return out


def layer_tail(x, lam: Pair, w_b, w_c, d, nw, nb, o2k=None, o2b=None,
               o1k=None, o1b=None, act: str = "gelu", glu: str = "none",
               relu_state: bool = False, layer_relu: bool = False,
               m1=None, m2=None, skip=None) -> torch.Tensor:
    """One layer's tail, (B, L, H) -> (B, L, H) in the stream's dtype. CUDA
    tensors launch the kernel's passes (or raise); CPU tensors take the
    plain version."""
    fn = layer_tail_cuda if x.is_cuda else layer_tail_plain
    return fn(x, lam, w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b, act=act,
              glu=glu, relu_state=relu_state, layer_relu=layer_relu,
              m1=m1, m2=m2, skip=skip)


class LayerTailFn(torch.autograd.Function):
    """Differentiable :func:`layer_tail`. The forward saves only its
    inputs; the backward recomputes the chain and returns the gradient of
    every tensor input (``ops/cuda/layer_tail_bwd.py``: the history and
    adjoint kernels for CUDA tensors, the plain adjoint for CPU tensors).
    Call as ``LayerTailFn.apply(x, lam_re, lam_im, w_b, w_c, d, nw, nb, o2k,
    o2b, o1k, o1b, m1, m2, act, glu, relu_state, layer_relu[, skip])``:
    without ``skip`` (affine mode) the gradient of ``x`` takes both of its
    paths and ``nw``/``nb`` get theirs; with ``skip`` (non-affine mode, the
    counterpart of passing ``z, skip`` to ``fused_layer_tail_diff``) ``x``
    and ``skip`` get ``g_z`` and ``g_skip`` and ``nw``/``nb`` are None."""

    @staticmethod
    def forward(ctx, x, lam_re, lam_im, w_b, w_c, d, nw, nb, o2k, o2b, o1k,
                o1b, m1, m2, act, glu, relu_state, layer_relu, skip=None):
        ctx.save_for_backward(x, lam_re, lam_im, w_b, w_c, d, nw, nb, o2k,
                              o2b, o1k, o1b, m1, m2, skip)
        ctx.flags = dict(act=act, glu=glu, relu_state=relu_state,
                         layer_relu=layer_relu)
        return layer_tail(x, (lam_re, lam_im), w_b, w_c, d, nw, nb, o2k,
                          o2b, o1k, o1b, m1=m1, m2=m2, skip=skip,
                          **ctx.flags)

    @staticmethod
    def backward(ctx, g):
        from sparsernns_tpu_torch.ops.cuda.layer_tail_bwd import \
            layer_tail_bwd
        (x, lam_re, lam_im, w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b, m1,
         m2, skip) = ctx.saved_tensors
        (g_x, g_skip, d_lam, d_w_b, d_w_c, d_d, d_o2k, d_o2b, d_o1k, d_o1b,
         d_m1, d_m2, d_nw, d_nb) = layer_tail_bwd(
            x, g, (lam_re, lam_im), w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b,
            m1=m1, m2=m2, skip=skip, **ctx.flags)
        return (g_x, d_lam[0], d_lam[1], d_w_b, d_w_c, d_d, d_nw, d_nb,
                d_o2k, d_o2b, d_o1k, d_o1b, d_m1, d_m2, None, None, None,
                None, g_skip)
