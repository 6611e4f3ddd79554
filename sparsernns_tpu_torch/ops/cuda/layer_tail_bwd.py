"""Kernels K3a and K3b: the backward of the whole-layer tail.

Replaces ``sparsernns_tpu/ops/pallas/fused_layer_bwd.py`` ``fused_tail_bwd``
in its affine and non-affine modes, on float32 and bfloat16 streams, the
two kernels it launches:

- K3a, the carry history (:func:`layer_tail_hist`): the scan state that
  enters every time block of a batch row, in forward order, (B, n_blocks, P)
  re and im, block 0 zero;
- K3b, the reverse-time adjoint (:func:`layer_tail_bwd`): per block, from
  its entry state, the forward chain again and then its adjoint, with the
  recurrence ``v_t = g_t + conj(λ) ⊙ v_{t+1}`` carried across blocks. It
  returns the gradient of every operand of
  :func:`~sparsernns_tpu_torch.ops.cuda.layer_tail.layer_tail`, in the
  order of the JAX package's ``_bwd``: ``(g_x, g_skip, (d_lam_re,
  d_lam_im), d_w_b, d_w_c, d_d, d_o2k, d_o2b, d_o1k, d_o1b, d_m1, d_m2,
  d_nw, d_nb)``. Affine mode: ``g_x`` takes both paths of the raw input,
  ``g_skip`` is None. Non-affine mode: ``g_x`` is the gradient of the
  normed ``z``, ``g_skip`` that of the residual (the masked cotangent),
  ``d_nw``, ``d_nb`` are None.

On a bfloat16 stream ``x`` / ``skip`` and the cotangent ``g`` are read as
bf16 and computed on in f32; ``g_x`` and ``g_skip`` round once to bf16,
and every weight gradient stays float32, as the JAX kernels keep them.

The CUDA source is ``csrc/layer_tail_bwd.cu``; its header note gives the
bounds and the design. The kernel emits the weight gradients per batch row
and this wrapper sums them over B, as the JAX package sums them outside its
kernel. The block of the history is the kernel's 32-row tile; it is not
numerics on this float path, so it need not equal the JAX ``block_t``.
CUDA tensors launch the kernels (or raise); CPU tensors take the plain
versions :func:`layer_tail_hist_plain` and :func:`layer_tail_bwd_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.cuda.layer_tail import (ACTS, GLU_KINDS,
                                                      check_tensors,
                                                      checked_operands,
                                                      data_ptr,
                                                      norm_and_residual)
from sparsernns_tpu_torch.ops.scan import Pair, sequential_diag_scan

#: time rows of one history block (the kernels' tile)
HIST_BLOCK = 32

#: launches of the history kernel and of the adjoint kernel in this process
launches_hist = 0
launches_bwd = 0

_GELU_K = 0.7978845608028654
_GELU_C = 0.044715


def _act_and_grad(y: torch.Tensor, act: str):
    """(act(y), act'(y)); gelu is the tanh form and so is its derivative."""
    if act == "relu":
        return torch.relu(y), (y > 0).to(y.dtype)
    th = torch.tanh(_GELU_K * (y + _GELU_C * y ** 3))
    x1 = 0.5 * y * (1.0 + th)
    dact = 0.5 * (1.0 + th) + 0.5 * y * (1.0 - th * th) * _GELU_K * (
        1.0 + 3.0 * _GELU_C * y * y)
    return x1, dact


def layer_tail_hist_plain(x, lam: Pair, w_b, nw, nb,
                          block: int = HIST_BLOCK) -> Pair:
    """Plain PyTorch version of K3a: the state entering each block of
    ``block`` rows, (B, ceil(L / block), P) re and im. ``nw = nb = None``:
    ``x`` is the normed stream (non-affine mode)."""
    p = w_b.shape[-1] // 2
    z = x.float() if nw is None else x.float() * nw + nb
    bu = z @ w_b
    xs, _ = sequential_diag_scan(lam, (bu[..., :p], bu[..., p:]))
    n_blocks = -(-x.shape[1] // block)
    last = torch.arange(1, n_blocks, device=x.device) * block - 1
    zero = torch.zeros_like(xs[0][:, :1])
    return (torch.cat([zero, xs[0][:, last]], dim=1),
            torch.cat([zero, xs[1][:, last]], dim=1))


def layer_tail_bwd_plain(x, g, lam: Pair, w_b, w_c, d, nw, nb, o2k=None,
                         o2b=None, o1k=None, o1b=None, act: str = "gelu",
                         glu: str = "none", relu_state: bool = False,
                         layer_relu: bool = False, m1=None, m2=None,
                         skip=None):
    """Plain PyTorch version of K3b: the explicit adjoint of
    ``layer_tail_plain``, a forward scan and a time-reversed scan with
    conj λ. ``g``: the cotangent of the output, (B, L, H), in the stream's
    dtype."""
    p = w_b.shape[-1] // 2
    axes = (0, 1)
    stream_dtype = x.dtype
    g = g.float()
    # ---- the forward chain again ----
    z, res = norm_and_residual(x, nw, nb, skip)
    bu = z @ w_b
    xs, _ = sequential_diag_scan(lam, (bu[..., :p], bu[..., p:]))
    xs_cat = torch.cat(xs, dim=-1)
    if relu_state:
        s_mask = (xs_cat > 0).to(g.dtype)
        xs_act = xs_cat * s_mask
    else:
        xs_act = xs_cat
    y = xs_act @ w_c + d * z
    x1, dact = _act_and_grad(y, act)
    x1d = x1 * m1 if m1 is not None else x1
    if glu != "none":
        gate = torch.sigmoid(x1d @ o2k + o2b)
        base = {"half1": x1d, "half2": y}.get(glu)
        if base is None:
            base = x1d @ o1k + o1b
        h = base * gate
        hd = h * m2 if m2 is not None else h
    else:
        hd = x1d
    # ---- adjoint chain, top down ----
    if layer_relu:
        g = g * ((hd + res) > 0).to(g.dtype)
    d_o2k = d_o2b = d_o1k = d_o1b = d_m1 = d_m2 = g_y_extra = None
    if glu != "none":
        g_h = g
        if m2 is not None:
            d_m2 = (g * h).sum(dim=1, keepdim=True)
            g_h = g * m2
        g_base = g_h * gate
        g_s = (g_h * base) * gate * (1.0 - gate)
        d_o2k = torch.einsum("blh,blq->hq", x1d, g_s)
        d_o2b = g_s.sum(dim=axes)
        g_x1d = g_s @ o2k.T
        if glu == "half1":
            g_x1d = g_x1d + g_base
        elif glu == "half2":
            g_y_extra = g_base
        else:
            d_o1k = torch.einsum("blh,blq->hq", x1d, g_base)
            d_o1b = g_base.sum(dim=axes)
            g_x1d = g_x1d + g_base @ o1k.T
    else:
        g_x1d = g
    g_x1 = g_x1d
    if m1 is not None:
        d_m1 = (g_x1d * x1).sum(dim=1, keepdim=True)
        g_x1 = g_x1d * m1
    g_y = g_x1 * dact
    if g_y_extra is not None:
        g_y = g_y + g_y_extra
    # ---- mixer adjoint: v_t = g_t + conj(lam) * v_{t+1} ----
    g_xs = g_y @ w_c.T
    if relu_state:
        g_xs = g_xs * s_mask
    rev = (g_xs[..., :p].flip(1), g_xs[..., p:].flip(1))
    v, _ = sequential_diag_scan((lam[0], -lam[1]), rev)
    v = (v[0].flip(1), v[1].flip(1))
    v_cat = torch.cat(v, dim=-1)
    g_z = v_cat @ w_b.T + g_y * d
    d_w_b = torch.einsum("blh,blq->hq", z, v_cat)
    d_w_c = torch.einsum("blq,blh->qh", xs_act, g_y)
    d_d = (g_y * z).sum(dim=axes)
    # previous-step raw states: row 0 is the zero initial state
    xp_re = torch.cat([torch.zeros_like(xs[0][:, :1]), xs[0][:, :-1]], dim=1)
    xp_im = torch.cat([torch.zeros_like(xs[1][:, :1]), xs[1][:, :-1]], dim=1)
    d_lam = ((v[0] * xp_re + v[1] * xp_im).sum(dim=axes),
             (v[1] * xp_re - v[0] * xp_im).sum(dim=axes))
    grads = (d_lam, d_w_b, d_w_c, d_d, d_o2k, d_o2b, d_o1k, d_o1b, d_m1,
             d_m2)
    if skip is not None:
        # z and skip are two inputs: g_z and the masked g (g_skip)
        return (g_z.to(stream_dtype), g.to(stream_dtype), *grads, None,
                None)
    # z = x ⊙ nw + nb and the residual x: both paths into g_x
    d_nw = (g_z * res).sum(dim=axes)
    d_nb = g_z.sum(dim=axes)
    g_x = g_z * nw + g
    return (g_x.to(stream_dtype), None, *grads, d_nw, d_nb)


def _fn(name: str, argtypes):
    fn = getattr(build.load("layer_tail_bwd"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _hist_launch(ops, b: int, l: int, h: int, p: int, device) -> Pair:
    global launches_hist
    tile = build.load("layer_tail_bwd").layer_tail_tile_rows()
    if tile != HIST_BLOCK:
        raise RuntimeError(f"kernel tile {tile} != HIST_BLOCK {HIST_BLOCK}")
    n_blocks = -(-l // HIST_BLOCK)
    hist = tuple(torch.empty((b, n_blocks, p), dtype=torch.float32,
                             device=device) for _ in range(2))
    fn = _fn("layer_tail_hist",
             [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*(data_ptr(ops, k) for k in ("x", "nw", "nb", "w_b", "lam_re",
                                          "lam_im")),
             hist[0].data_ptr(), hist[1].data_ptr(), b, l, h, p,
             int(ops["x"].dtype == torch.bfloat16), stream)
    build.check(err, "layer_tail_hist")
    launches_hist += 1
    return hist


def layer_tail_hist_cuda(x, lam: Pair, w_b, nw, nb) -> Pair:
    """Launch K3a (one CTA per batch row). ``nw = nb = None``: ``x`` is the
    normed stream (non-affine mode)."""
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (B, L, H), got "
                         f"{tuple(x.shape)}")
    if (nw is None) != (nb is None):
        raise ValueError("nw and nb come together (affine mode) or not at "
                         "all (non-affine mode)")
    b, l, h = x.shape
    p = w_b.shape[-1] // 2
    shapes = {"x": (x, (b, l, h)), "lam_re": (lam[0], (p,)),
              "lam_im": (lam[1], (p,)), "w_b": (w_b, (h, 2 * p))}
    if nw is not None:
        shapes.update(nw=(nw, (h,)), nb=(nb, (h,)))
    ops = check_tensors(shapes, x.device, ("x",))
    return _hist_launch(ops, b, l, h, p, x.device)


def layer_tail_hist(x, lam: Pair, w_b, nw, nb) -> Pair:
    """Entry states of every block of :data:`HIST_BLOCK` rows."""
    fn = layer_tail_hist_cuda if x.is_cuda else layer_tail_hist_plain
    return fn(x, lam, w_b, nw, nb)


def layer_tail_bwd_cuda(x, g, lam: Pair, w_b, w_c, d, nw, nb, o2k=None,
                        o2b=None, o1k=None, o1b=None, act: str = "gelu",
                        glu: str = "none", relu_state: bool = False,
                        layer_relu: bool = False, m1=None, m2=None,
                        skip=None):
    """Launch K3a, then K3b (one CTA per batch row each), and sum the
    per-row weight gradients over B. Same arguments and result as
    :func:`layer_tail_bwd_plain`; every tensor on one CUDA device, the
    streams (``x``, ``g``, ``skip``) float32 or bfloat16, the rest
    float32."""
    global launches_bwd
    ops = checked_operands(x, lam, w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b,
                           m1, m2, act, glu, skip=skip, g=g)
    b, l, h = x.shape
    p = w_b.shape[-1] // 2
    if l == 0 or b == 0:
        raise ValueError(f"empty stream {tuple(x.shape)}")
    dev = x.device
    hist = _hist_launch(ops, b, l, h, p, dev)
    # transposed copies for the products with a transposed weight: layout,
    # made once per call; the products themselves run in the kernel
    for name in ("w_b", "w_c", "o2k", "o1k"):
        if name in ops:
            ops[name + "T"] = ops[name].T.contiguous()
    new = lambda *shape: torch.empty(  # noqa: E731
        shape, dtype=torch.float32, device=dev)
    outs = {"gx": torch.empty((b, l, h), dtype=x.dtype, device=dev),
            "dwb": new(b, h, 2 * p), "dwc": new(b, 2 * p, h),
            "dd": new(b, h), "dlam_re": new(b, p), "dlam_im": new(b, p)}
    if skip is None:
        outs.update(dnw=new(b, h), dnb=new(b, h))
    else:
        outs["gskip"] = torch.empty((b, l, h), dtype=x.dtype, device=dev)
    if glu != "none":
        outs.update(do2k=new(b, h, h), do2b=new(b, h))
    if glu == "full":
        outs.update(do1k=new(b, h, h), do1b=new(b, h))
    if m1 is not None:
        outs["dm1"] = new(b, 1, h)
    if m2 is not None:
        outs["dm2"] = new(b, 1, h)
    # the order of BwdArgs in csrc/layer_tail_bwd.cu
    in_names = ("x", "g", "skip", "nw", "nb", "w_b", "w_c", "w_bT", "w_cT",
                "d", "lam_re", "lam_im", "o2k", "o2kT", "o2b", "o1k", "o1kT",
                "o1b", "m1", "m2")
    out_names = ("gx", "gskip", "dwb", "dwc", "do2k", "do1k", "dd", "do2b",
                 "do1b", "dm1", "dm2", "dnw", "dnb", "dlam_re", "dlam_im")
    ptrs = [data_ptr(ops, k) for k in in_names]
    ptrs += [hist[0].data_ptr(), hist[1].data_ptr()]
    ptrs += [data_ptr(outs, k) for k in out_names]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    fn = _fn("layer_tail_bwd",
             [ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(table, b, l, h, p, GLU_KINDS.index(glu), ACTS.index(act),
             int(relu_state), int(layer_relu),
             int(x.dtype == torch.bfloat16), stream)
    build.check(err, "layer_tail_bwd")
    launches_bwd += 1
    # the sums over the batch stay outside the kernel, as in the JAX package
    total = lambda k: outs[k].sum(dim=0) if k in outs else None  # noqa: E731
    return (outs["gx"], outs.get("gskip"),
            (total("dlam_re"), total("dlam_im")), total("dwb"),
            total("dwc"), total("dd"), total("do2k"), total("do2b"),
            total("do1k"), total("do1b"), outs.get("dm1"), outs.get("dm2"),
            total("dnw"), total("dnb"))


def layer_tail_bwd(x, g, lam: Pair, w_b, w_c, d, nw, nb, o2k=None, o2b=None,
                   o1k=None, o1b=None, act: str = "gelu", glu: str = "none",
                   relu_state: bool = False, layer_relu: bool = False,
                   m1=None, m2=None, skip=None):
    """Backward of one layer's tail. CUDA tensors launch the history and
    adjoint kernels (or raise); CPU tensors take the plain adjoint."""
    fn = layer_tail_bwd_cuda if x.is_cuda else layer_tail_bwd_plain
    return fn(x, g, lam, w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b, act=act,
              glu=glu, relu_state=relu_state, layer_relu=layer_relu,
              m1=m1, m2=m2, skip=skip)
