"""Kernels K3a and K3b: the backward of the whole-layer tail.

Replaces ``sparsernns_tpu/ops/pallas/fused_layer_bwd.py`` ``fused_tail_bwd``
in its affine and non-affine modes, on float32 and bfloat16 streams, the
two kernels it launches:

- K3a, the carry history (:func:`layer_tail_hist`): the scan state that
  enters every time block of a batch row, in forward order, (B, n_blocks, P)
  re and im, block 0 zero. On the card it computes every state on the way
  (a B-projection pass over all rows, then one sequential scan per batch
  row and channel) and the backward keeps them;
- K3b, the adjoint (:func:`layer_tail_bwd`): the forward chain again from
  those states, then its adjoint, with the recurrence ``v_t = g_t +
  conj(λ) ⊙ v_{t+1}`` walked in reverse time. It returns the gradient of
  every operand of
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
passes, their bounds and the design. Only the two recurrences walk time;
every other pass runs over chunks of :data:`CHUNK` rows of one batch row
(:func:`bwd_plan`), with the arrays between the passes in device memory
(:func:`scratch_shapes`). The kernels write every sum over time as
partials, per chunk or per slice of rows, and :func:`reduce_partials` sums
them in a fixed order, as the JAX package sums over the batch outside its
kernel. :func:`launched` reads back the kernels and grids of the last call
on the card, as the CUDA source recorded them. The block of the history is
32 rows; it is not
numerics on this float path, so it need not equal the JAX ``block_t``.
CUDA tensors launch the kernels (or raise); CPU tensors take the plain
versions :func:`layer_tail_hist_plain` and :func:`layer_tail_bwd_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Tuple

import torch

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.cuda.layer_tail import (ACTS, GLU_KINDS,
                                                      check_tensors,
                                                      checked_operands,
                                                      data_ptr,
                                                      norm_and_residual)
from sparsernns_tpu_torch.ops.scan import Pair, sequential_diag_scan
from sparsernns_tpu_torch.utils.trace import count, traced

#: time rows of one history block
HIST_BLOCK = 32
#: time rows of a chunk: the product passes' row tile (``kBM`` in the CUDA
#: source, which the wrapper checks)
CHUNK = 128
#: the weight-gradient products cut the B * L rows into about this many
#: slices of whole chunks
WGRAD_SPLITS = 48
#: the vector gradients that the kernels sum per chunk, in their slot order
VEC_SLOTS = ("d", "o2b", "o1b", "m1", "m2", "nw", "nb")

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


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How K3a and K3b cut one backward over the card: the product passes
    take chunks of ``chunk`` time rows of one batch row (a CTA per chunk
    and column tile), the weight-gradient products slices of
    ``split_rows`` of the B * L rows (a CTA per slice and output tile),
    each CTA writing its partial to its own slot."""

    batch: int
    length: int
    chunk: int
    split_rows: int

    @property
    def chunks_per_row(self) -> int:
        return -(-self.length // self.chunk)

    @property
    def n_chunks(self) -> int:
        return self.batch * self.chunks_per_row

    @property
    def rows(self) -> int:
        return self.batch * self.length

    @property
    def n_splits(self) -> int:
        return -(-self.rows // self.split_rows)

    def chunks(self) -> List[Tuple[int, int, int]]:
        """(batch row, first step, end step) of every chunk, in the
        kernels' order: chunk ``b * chunks_per_row + i``."""
        return [(b, t0, min(t0 + self.chunk, self.length))
                for b in range(self.batch)
                for t0 in range(0, self.length, self.chunk)]

    def splits(self) -> List[Tuple[int, int]]:
        """(first row, end row) of every weight-gradient slice of the
        flattened B * L rows."""
        return [(r0, min(r0 + self.split_rows, self.rows))
                for r0 in range(0, self.rows, self.split_rows)]


def bwd_plan(batch: int, length: int) -> BwdPlan:
    """The plan of one backward, a pure function of (B, L), so the order of
    every partial sum is fixed. Chunks are the passes' row tile: B *
    ceil(L / 128) of them, 240 at B = 8, L = 3751, each times the column
    tiles of a product (three for H = 192), so every SM has work from B = 8
    on. The weight gradients take about :data:`WGRAD_SPLITS` slices of
    whole chunks' rows."""
    if batch < 1 or length < 1:
        raise ValueError(f"empty backward: B={batch}, L={length}")
    per_split = -(-batch * length // WGRAD_SPLITS)
    return BwdPlan(batch, length, CHUNK, CHUNK * -(-per_split // CHUNK))


def scratch_shapes(plan: BwdPlan, h: int, p: int,
                   glu: str) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the float32 arrays between the passes (``S``: the raw
    states [re | im]; ``Y``, ``X1D``: y and x1 after m1; ``F``: the full
    GLU's base; ``G``: the masked cotangent; ``GS``: [g_s | g_base]; ``GY``:
    g_y; ``V``: g_xs, then v) and of the partial sums (``vec``: per chunk
    and :data:`VEC_SLOTS` slot; ``dlam``: per batch row; ``dwc``, ``dglu``
    ([d_o2k | d_o1k]), ``dwb`` (d_w_b transposed): per slice). Arrays that the GLU variant
    does not use are left out."""
    rows = plan.rows
    gated = glu != "none"
    shapes = {"S": (rows, 2 * p)}
    if gated:
        shapes.update(Y=(rows, h), X1D=(rows, h))
    if glu == "full":
        shapes["F"] = (rows, h)
    shapes["G"] = (rows, h)
    if gated:
        shapes["GS"] = (rows, 2 * h)
    shapes.update(GY=(rows, h), V=(rows, 2 * p),
                  vec=(plan.n_chunks, len(VEC_SLOTS), h),
                  dlam=(2, plan.batch, p), dwc=(plan.n_splits, 2 * p, h))
    if gated:
        shapes["dglu"] = (plan.n_splits, h, (2 if glu == "full" else 1) * h)
    shapes["dwb"] = (plan.n_splits, 2 * p, h)
    return shapes


def reduce_partials(plan: BwdPlan, parts: Dict[str, torch.Tensor],
                    glu: str, affine: bool, masks: Tuple[bool, bool]):
    """The weight gradients of the ``_bwd`` tuple, ``((d_lam_re, d_lam_im),
    d_w_b, d_w_c, d_d, d_o2k, d_o2b, d_o1k, d_o1b, d_m1, d_m2, d_nw,
    d_nb)``, from the kernels' partials: each a sum over the slices, chunks
    or batch rows in their fixed order (d_m1, d_m2 per batch row, (B, 1,
    H)). ``masks``: whether m1 and m2 were given."""
    vec = parts["vec"]
    h = vec.shape[-1]
    vec = vec.view(plan.batch, plan.chunks_per_row, len(VEC_SLOTS), h)
    slot = lambda name: vec[:, :, VEC_SLOTS.index(name)]  # noqa: E731
    total = lambda name: slot(name).sum(dim=(0, 1))  # noqa: E731
    d_glu = parts["dglu"].sum(dim=0) if glu != "none" else None
    dlam = parts["dlam"].sum(dim=1)
    return ((dlam[0], dlam[1]), parts["dwb"].sum(dim=0).T.contiguous(),
            parts["dwc"].sum(dim=0), total("d"),
            None if d_glu is None else d_glu[:, :h].contiguous(),
            None if d_glu is None else total("o2b"),
            d_glu[:, h:].contiguous() if glu == "full" else None,
            total("o1b") if glu == "full" else None,
            slot("m1").sum(dim=1, keepdim=True) if masks[0] else None,
            slot("m2").sum(dim=1, keepdim=True) if masks[1] else None,
            total("nw") if affine else None,
            total("nb") if affine else None)


_HIST_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def launched() -> Dict[str, Dict[str, int]]:
    """The kernels that the last K3a and the last K3b call on the card
    launched, each with its grid's CTAs, in launch order, as the CUDA
    source recorded them at the launch: ``{"K3a": {name: ctas}, "K3b":
    {name: ctas}}``. The names are the ``__global__`` s' (with their
    template arguments), as the profiler shows them."""
    fn = build.entry("layer_tail_bwd", "layer_tail_launched",
                     [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int])
    cap = 16
    res = {}
    for call, kernel in enumerate(("K3a", "K3b")):
        names = (ctypes.c_char_p * cap)()
        ctas = (ctypes.c_longlong * cap)()
        n = fn(call, names, ctas, cap)
        res[kernel] = {names[i].decode(): ctas[i] for i in range(min(n, cap))}
    return res


def _hist_launch(ops, plan: BwdPlan, h: int, p: int, states) -> Pair:
    """Launch K3a: every state into ``states`` ((B, L, 2P) float32), and
    the history, which it returns."""
    tile = build.entry("layer_tail_bwd", "layer_tail_tile_rows", [])
    chunk = build.entry("layer_tail_bwd", "layer_tail_chunk_rows", [])
    if (tile(), chunk()) != (HIST_BLOCK, plan.chunk):
        raise RuntimeError("the kernels' tiles differ from HIST_BLOCK / "
                           "CHUNK")
    b, l = plan.batch, plan.length
    device = states.device
    n_blocks = -(-l // HIST_BLOCK)
    hist = tuple(torch.empty((b, n_blocks, p), dtype=torch.float32,
                             device=device) for _ in range(2))
    fn = build.entry("layer_tail_bwd", "layer_tail_hist", _HIST_ARGS)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*(data_ptr(ops, k) for k in ("x", "nw", "nb", "w_b", "lam_re",
                                          "lam_im")),
             states.data_ptr(), hist[0].data_ptr(), hist[1].data_ptr(), b, l,
             h, p, int(ops["x"].dtype == torch.bfloat16), stream)
    build.check(err, "layer_tail_hist")
    count("layer_tail_hist")
    return hist


@traced("kernel.layer_tail_hist")
def layer_tail_hist_cuda(x, lam: Pair, w_b, nw, nb) -> Pair:
    """Launch K3a (a B-projection pass over all rows, then the scan per
    batch row and channel). ``nw = nb = None``: ``x`` is the normed stream
    (non-affine mode)."""
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
    states = torch.empty((b, l, 2 * p), dtype=torch.float32, device=x.device)
    return _hist_launch(ops, bwd_plan(b, l), h, p, states)


def layer_tail_hist(x, lam: Pair, w_b, nw, nb) -> Pair:
    """Entry states of every block of :data:`HIST_BLOCK` rows."""
    fn = layer_tail_hist_cuda if x.is_cuda else layer_tail_hist_plain
    return fn(x, lam, w_b, nw, nb)


@traced("kernel.layer_tail_bwd")
def layer_tail_bwd_cuda(x, g, lam: Pair, w_b, w_c, d, nw, nb, o2k=None,
                        o2b=None, o1k=None, o1b=None, act: str = "gelu",
                        glu: str = "none", relu_state: bool = False,
                        layer_relu: bool = False, m1=None, m2=None,
                        skip=None):
    """Launch K3a, then K3b's passes, and sum their partials. Same
    arguments and result as :func:`layer_tail_bwd_plain`; every tensor on
    one CUDA device, the streams (``x``, ``g``, ``skip``) float32 or
    bfloat16, the rest float32."""
    ops = checked_operands(x, lam, w_b, w_c, d, nw, nb, o2k, o2b, o1k, o1b,
                           m1, m2, act, glu, skip=skip, g=g)
    b, l, h = x.shape
    p = w_b.shape[-1] // 2
    if l == 0 or b == 0:
        raise ValueError(f"empty stream {tuple(x.shape)}")
    dev = x.device
    plan = bwd_plan(b, l)
    bufs = {k: torch.empty(shape, dtype=torch.float32, device=dev)
            for k, shape in scratch_shapes(plan, h, p, glu).items()}
    _hist_launch(ops, plan, h, p, bufs["S"])
    # transposed copies for the products with a transposed weight: layout,
    # made once per call; the products themselves run in the kernels
    ops["w_bT"] = ops["w_b"].T.contiguous()
    ops["w_cT"] = ops["w_c"].T.contiguous()
    if glu != "none":   # [W2^T; W1^T] for the full GLU, one array
        ops["gluT"] = torch.cat([ops[k].T for k in ("o2k", "o1k")
                                 if k in ops]).contiguous()
    bufs["gx"] = torch.empty((b, l, h), dtype=x.dtype, device=dev)
    if skip is not None:
        bufs["gskip"] = torch.empty((b, l, h), dtype=x.dtype, device=dev)
    # the order of BwdArgs in csrc/layer_tail_bwd.cu
    in_names = ("x", "g", "skip", "nw", "nb", "w_b", "w_c", "w_bT", "w_cT",
                "d", "lam_re", "lam_im", "o2k", "o2b", "o1k", "o1b", "gluT",
                "m1", "m2")
    buf_names = ("S", "Y", "X1D", "F", "G", "GS", "GY", "V", "gx", "gskip",
                 "vec", "dlam", "dwc", "dglu", "dwb")
    ptrs = [data_ptr(ops, k) for k in in_names]
    ptrs += [data_ptr(bufs, k) for k in buf_names]
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    fn = build.entry("layer_tail_bwd", "layer_tail_bwd", _BWD_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(table, b, l, h, p, GLU_KINDS.index(glu), ACTS.index(act),
             int(relu_state), int(layer_relu),
             int(x.dtype == torch.bfloat16), plan.split_rows, stream)
    build.check(err, "layer_tail_bwd")
    count("layer_tail_bwd")
    return (bufs["gx"], bufs.get("gskip"),
            *reduce_partials(plan, bufs, glu, skip is None,
                             (m1 is not None, m2 is not None)))


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
