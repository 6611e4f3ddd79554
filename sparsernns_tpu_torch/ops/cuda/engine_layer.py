"""Kernels K5a / K5b: one quantized serving layer in one kernel.

Replaces ``sparsernns_tpu/ops/pallas/fused_layer.py`` ``fused_layer_apply``
(K5a) and ``fused_layer_apply_carry`` (K5b, with a carry in and out) in
float-dot mode. Per batch row, over a residual stream stored as the integer
codes of its frozen grid (int16 / int8), bf16 or f32::

    r  = stream * in_requant scale
    z  = r * nw + nb                       (prenorm; else z = r)
    bu = (z @ W_b) * wb_scales             (int8 / int16 / f32 weights)
    xs = scan(lam, bu), requantized onto block_requant per time block
    y  = [xs_re * wc_re | xs_im * wc_im] @ W_c + d * z    (relu on xs)
    x1 = relu(y) or gelu(y);  h = GLU(x1, y) + r
    (postnorm) -> relu if relufication -> codes of out_requant

**The time block is numerics.** ``block_t`` frames form one block: inside
it the recurrence runs on unquantized float32, after it every state of the
block is requantized and the requantized last state is the carry into the
next block. The caller passes the effective block of its route.

The serving stack's first launch may run the encoder dense before the
layer (``enc``) and its last launch the decoder dense after it (``dec``),
so that the stack route sums every product exactly as the whole-network
kernel does (``engine_network.py``) and the two stay bit-identical.

The CUDA source is ``csrc/engine_layer.cu`` over ``csrc/engine_body.cuh``.
:func:`engine_layer` launches the kernel for CUDA tensors (or raises) and
takes the plain version :func:`engine_layer_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.scan import (Pair, grid_value, quant_codes,
                                           sequential_diag_scan)

GLU_KINDS = ("full", "half1", "half2", "none")

#: kernel launches made in this process without / with a carry (K5a / K5b)
launches = 0
launches_carry = 0

#: (QWeight-like kernel with .data (in, out) and .scale, bias (out,))
Dense = Tuple[Any, torch.Tensor]


class LayerMode(NamedTuple):
    """What every layer of one engine shares."""

    prenorm: bool = True
    relufication: bool = False
    glu: str = "half1"
    relu_state: bool = False
    act_dtype: torch.dtype = torch.bfloat16


def requant_storage_dtype(bits: int) -> torch.dtype:
    """Stream storage of a requant of ``bits``: its integer codes at the
    smallest width that holds them."""
    return torch.int8 if bits <= 8 else torch.int16


def stream_dtype(layer, mode: LayerMode) -> torch.dtype:
    """Storage type of the stream a layer writes."""
    if layer.residual_requant is not None:
        return requant_storage_dtype(layer.residual_requant[1])
    return mode.act_dtype


# ---------------------------------------------------------------- plain

def qdq(x: torch.Tensor, spec: Optional[Tuple[float, int]]) -> torch.Tensor:
    """Quantize-dequantize onto a frozen grid; None passes through."""
    return x if spec is None else grid_value(x, *spec)


def dense_plain(x: torch.Tensor, dense: Dense) -> torch.Tensor:
    """(x @ W as float32) * weight scale + bias."""
    kernel, bias = dense
    r = x @ kernel.data.to(torch.float32)
    if kernel.scale is not None:
        r = r * kernel.scale
    return r + bias


def stream_value(h: torch.Tensor, layer, mode: LayerMode) -> torch.Tensor:
    """What the next reader of the stream sees of a layer's output h:
    storing the codes (or the activation type) and loading them again."""
    if layer.residual_requant is not None:
        return qdq(h, layer.residual_requant)
    return h.to(mode.act_dtype).to(torch.float32)


def encode_plain(x: torch.Tensor, enc: Dense, mode: LayerMode
                 ) -> torch.Tensor:
    h = dense_plain(x.to(torch.float32), enc)
    if mode.relufication:
        h = torch.relu(h)
    return h.to(mode.act_dtype).to(torch.float32)


class MixerOps(NamedTuple):
    """The serving mixer's operands under the names a ``_LayerPack`` of
    the engine gives them, so either can be handed to :func:`mixer_plain`
    and :func:`pack_mixer`."""

    lam: Pair                 # (P,) f32 pair
    w_b: torch.Tensor         # (H, 2P) int8 / int16 / f32
    w_c: torch.Tensor         # (2P, H), conj-sym factor in the scales or w
    d: torch.Tensor           # (H,) f32
    wb_scales: Optional[Tuple[float, float]] = None
    wc_scales: Optional[Tuple[float, float]] = None
    #: (s_re, s_im, bits) of the blockwise state requant
    state_requant: Optional[Tuple[float, float, int]] = None


def mixer_plain(z: torch.Tensor, layer, relu_state: bool, carry: Pair
                ) -> Tuple[torch.Tensor, Pair]:
    """The mixer on ONE time block z (B, T, H) float32 from ``carry``:
    B-projection with the per-half scales, the recurrence, every state on
    the frozen grid and the requantized last state as the next carry,
    relu, C-side scales, C-projection + d * z. Returns (y, carry)."""
    p = layer.w_b.shape[-1] // 2
    bu = z @ layer.w_b.to(torch.float32)
    bu_re, bu_im = bu[..., :p], bu[..., p:]
    if layer.wb_scales is not None:
        bu_re = bu_re * layer.wb_scales[0]
        bu_im = bu_im * layer.wb_scales[1]
    (x_re, x_im), _ = sequential_diag_scan(layer.lam, (bu_re, bu_im), carry)
    if layer.state_requant is not None:
        s_re, s_im, bits = layer.state_requant
        x_re, x_im = qdq(x_re, (s_re, bits)), qdq(x_im, (s_im, bits))
    carry = (x_re[:, -1], x_im[:, -1])
    if relu_state:
        x_re, x_im = torch.relu(x_re), torch.relu(x_im)
    if layer.wc_scales is not None:
        x_re, x_im = x_re * layer.wc_scales[0], x_im * layer.wc_scales[1]
    y = torch.cat([x_re, x_im], dim=-1) @ layer.w_c.to(torch.float32)
    return y + layer.d * z, carry


def layer_body_plain(r: torch.Tensor, layer, mode: LayerMode,
                     carry: Pair) -> Tuple[torch.Tensor, Pair]:
    """The layer on ONE time block r (B, T, H) of float32 stream values,
    starting from ``carry``. Returns (h before the output requant, the
    carry into the next block)."""
    z = r * layer.norm_w + layer.norm_b if mode.prenorm else r
    y, carry = mixer_plain(z, layer, mode.relu_state, carry)
    x1 = torch.relu(y) if mode.relufication else F.gelu(
        y, approximate="tanh")
    if mode.glu == "none":
        h = x1
    else:
        gate = torch.sigmoid(
            dense_plain(x1, (layer.out2_kernel, layer.out2_bias)))
        if mode.glu == "half1":
            base = x1
        elif mode.glu == "half2":
            base = y
        else:
            base = dense_plain(x1, (layer.out1_kernel, layer.out1_bias))
        h = base * gate
    h = h + r
    if not mode.prenorm:
        h = h * layer.norm_w + layer.norm_b
    if mode.relufication:
        h = torch.relu(h)
    return h, carry


def zero_carry(x: torch.Tensor, layer) -> Pair:
    p = layer.w_b.shape[-1] // 2
    z = torch.zeros((x.shape[0], p), dtype=torch.float32, device=x.device)
    return z, z.clone()


def _check_args(r, layer, mode: LayerMode, block_t: int, enc):
    if mode.glu not in GLU_KINDS:
        raise ValueError(f"glu {mode.glu!r}")
    if r.dim() != 3:
        raise ValueError(f"expected (B, L, width), got {tuple(r.shape)}")
    if block_t < 1:
        raise ValueError(f"block_t {block_t}")
    width = enc[0].data.shape[0] if enc is not None else layer.w_b.shape[0]
    if r.shape[-1] != width:
        raise ValueError(f"last axis {r.shape[-1]}, expected {width}")


def engine_layer_plain(r: torch.Tensor, layer, mode: LayerMode, *,
                       block_t: int,
                       in_requant: Optional[Tuple[float, int]] = None,
                       carry: Optional[Pair] = None,
                       enc: Optional[Dense] = None,
                       dec: Optional[Dense] = None,
                       out_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version: a loop over time blocks, the recurrence step
    by step inside each. ``r`` is the stream (B, L, H) as stored (codes of
    ``in_requant``, or floats), or with ``enc`` the input (B, L, d_in).
    Returns the stream as stored, or with ``dec`` the (B, L, d_out) output
    in ``out_dtype``; with ``carry`` also the final carry."""
    _check_args(r, layer, mode, block_t, enc)
    state = carry if carry is not None else zero_carry(r, layer)
    outs = []
    for s in range(0, r.shape[1], block_t):
        blk = r[:, s:s + block_t]
        if enc is not None:
            blk = encode_plain(blk, enc, mode)
        else:
            blk = blk.to(torch.float32)
            if in_requant is not None:
                blk = blk * in_requant[0]
        h, state = layer_body_plain(blk, layer, mode, state)
        if dec is not None:
            out = dense_plain(stream_value(h, layer, mode), dec)
            outs.append(out.to(out_dtype))
        elif layer.residual_requant is not None:
            outs.append(quant_codes(h, layer.residual_requant).to(
                stream_dtype(layer, mode)))
        else:
            outs.append(h.to(mode.act_dtype))
    out = torch.cat(outs, dim=1)
    return out if carry is None else (out, state)


# ----------------------------------------------------------------- CUDA

class DenseW(ctypes.Structure):
    """``engine::DenseW`` of ``csrc/engine_body.cuh``."""

    _fields_ = [("w", ctypes.c_void_p), ("bias", ctypes.c_void_p),
                ("scale", ctypes.c_float), ("wtype", ctypes.c_int)]


class LayerParams(ctypes.Structure):
    """``engine::LayerParams`` of ``csrc/engine_body.cuh``."""

    _fields_ = (
        [(n, ctypes.c_void_p)
         for n in ("lam_re", "lam_im", "d", "nw", "nb")]
        + [(n, DenseW) for n in ("wb", "wc", "out2", "out1")]
        + [(n, ctypes.c_float)
           for n in ("wb_s_re", "wb_s_im", "wc_s_re", "wc_s_im", "sq_re",
                     "sq_im", "sq_min", "sq_max", "rq_s", "rq_min",
                     "rq_max")]
        + [(n, ctypes.c_int) for n in ("has_sq", "has_rq", "p")])


class Mode(ctypes.Structure):
    """``engine::Mode`` of ``csrc/engine_body.cuh``."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "h", "prenorm", "relufication", "glu", "relu_state", "act_bf16")]


WTYPES = {torch.float32: 0, torch.int8: 1, torch.int16: 2}
IO_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2,
            torch.int8: 3}


def _ptr(t: torch.Tensor, name: str, shape, dtype, device) -> int:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: expected {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def pack_weight(w: torch.Tensor, scale: Optional[float],
                bias: Optional[torch.Tensor], name: str, shape,
                device) -> DenseW:
    if w.dtype not in WTYPES:
        raise ValueError(f"{name}: weight dtype {w.dtype}")
    out = DenseW()
    out.w = _ptr(w, name, shape, w.dtype, device)
    out.bias = (None if bias is None else
                _ptr(bias, f"{name} bias", (shape[1],), torch.float32,
                     device))
    out.scale = 1.0 if scale is None else float(scale)
    out.wtype = WTYPES[w.dtype]
    return out


def pack_dense(dense: Optional[Dense], name: str, shape, device) -> DenseW:
    if dense is None:
        return DenseW()
    kernel, bias = dense
    return pack_weight(kernel.data, kernel.scale, bias, name, shape, device)


def pack_mixer(layer, device) -> LayerParams:
    """The mixer's operands of a layer (or a :class:`MixerOps`) as the
    kernel's struct, without the norm and the GLU (pointers into the
    layer's own tensors, which must outlive the launch)."""
    h = layer.w_b.shape[0]
    p = layer.w_b.shape[-1] // 2
    f32 = torch.float32
    lp = LayerParams()
    lp.lam_re = _ptr(layer.lam[0], "lam_re", (p,), f32, device)
    lp.lam_im = _ptr(layer.lam[1], "lam_im", (p,), f32, device)
    lp.d = _ptr(layer.d, "d", (h,), f32, device)
    lp.wb = pack_weight(layer.w_b, None, None, "w_b", (h, 2 * p), device)
    lp.wc = pack_weight(layer.w_c, None, None, "w_c", (2 * p, h), device)
    lp.wb_s_re, lp.wb_s_im = layer.wb_scales or (1.0, 1.0)
    lp.wc_s_re, lp.wc_s_im = layer.wc_scales or (1.0, 1.0)
    if layer.state_requant is not None:
        s_re, s_im, bits = layer.state_requant
        lp.has_sq, lp.sq_re, lp.sq_im = 1, s_re, s_im
        lp.sq_min, lp.sq_max = -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1
    lp.p = p
    return lp


def pack_layer(layer, mode: LayerMode, device) -> LayerParams:
    """One layer's operands as the kernel's struct (pointers into the
    layer's own tensors, which must outlive the launch)."""
    h = layer.w_b.shape[0]
    f32 = torch.float32
    lp = pack_mixer(layer, device)
    lp.nw = _ptr(layer.norm_w, "norm_w", (h,), f32, device)
    lp.nb = _ptr(layer.norm_b, "norm_b", (h,), f32, device)
    if mode.glu != "none":
        lp.out2 = pack_dense((layer.out2_kernel, layer.out2_bias), "out2",
                             (h, h), device)
    if mode.glu == "full":
        lp.out1 = pack_dense((layer.out1_kernel, layer.out1_bias), "out1",
                             (h, h), device)
    if layer.residual_requant is not None:
        s, bits = layer.residual_requant
        if bits > 16:
            raise ValueError("residual requant wider than 16 bits")
        lp.has_rq, lp.rq_s = 1, s
        lp.rq_min, lp.rq_max = -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1
    return lp


def pack_mode(mode: LayerMode, h: int) -> Mode:
    if mode.act_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"act_dtype {mode.act_dtype}")
    return Mode(h, int(mode.prenorm), int(mode.relufication),
                GLU_KINDS.index(mode.glu), int(mode.relu_state),
                int(mode.act_dtype == torch.bfloat16))


def _lib():
    fn = build.load("engine_layer").engine_layer_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.POINTER(LayerParams),
             ctypes.POINTER(Mode), ctypes.POINTER(DenseW), ctypes.c_int,
             ctypes.POINTER(DenseW), ctypes.c_int]
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def engine_layer_cuda(r: torch.Tensor, layer, mode: LayerMode, *,
                      block_t: int,
                      in_requant: Optional[Tuple[float, int]] = None,
                      carry: Optional[Pair] = None,
                      enc: Optional[Dense] = None,
                      dec: Optional[Dense] = None,
                      out_dtype: torch.dtype = torch.float32):
    """Launch the kernel (one CTA per batch row). Same arguments and
    results as :func:`engine_layer_plain`; every tensor on ``r``'s CUDA
    device."""
    global launches, launches_carry
    _check_args(r, layer, mode, block_t, enc)
    dev = r.device
    b, l, _ = r.shape
    h = layer.w_b.shape[0]
    p = layer.w_b.shape[-1] // 2
    if enc is None:
        want = (mode.act_dtype if in_requant is None
                else requant_storage_dtype(in_requant[1]))
        if r.dtype != want:
            raise ValueError(f"stream dtype {r.dtype}, expected {want}")
    if r.dtype not in IO_TYPES or out_dtype not in IO_TYPES:
        raise ValueError(f"io dtypes {r.dtype} / {out_dtype}")
    r = r.contiguous()
    d_in = enc[0].data.shape[0] if enc is not None else 0
    d_out = dec[0].data.shape[1] if dec is not None else 0
    o_dtype = out_dtype if dec is not None else stream_dtype(layer, mode)
    out = torch.empty((b, l, d_out if dec is not None else h),
                      dtype=o_dtype, device=dev)
    lp = pack_layer(layer, mode, dev)
    md = pack_mode(mode, h)
    enc_w = pack_dense(enc, "encoder", (d_in, h), dev)
    dec_w = pack_dense(dec, "decoder", (h, d_out), dev)
    ci = co = (None, None)
    if carry is not None:
        ci = tuple(c.contiguous() for c in carry)
        co = (torch.empty((b, p), dtype=torch.float32, device=dev),
              torch.empty((b, p), dtype=torch.float32, device=dev))
        ci_ptr = [_ptr(c, "carry", (b, p), torch.float32, dev) for c in ci]
        co_ptr = [c.data_ptr() for c in co]
    else:
        ci_ptr = co_ptr = [None, None]
    if b == 0 or l == 0:
        return out if carry is None else (out, carry)
    err = _lib()(
        r.data_ptr(), out.data_ptr(), IO_TYPES[r.dtype], IO_TYPES[o_dtype],
        1.0 if in_requant is None else float(in_requant[0]),
        ctypes.byref(lp), ctypes.byref(md), ctypes.byref(enc_w), d_in,
        ctypes.byref(dec_w), d_out, *ci_ptr, *co_ptr, b, l, int(block_t),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "engine_layer")
    if carry is None:
        launches += 1
        return out
    launches_carry += 1
    return out, co


def engine_layer(r: torch.Tensor, layer, mode: LayerMode, **kw):
    """One serving layer over the stored stream. CUDA tensors launch the
    kernel (or raise); CPU tensors take the plain version."""
    fn = engine_layer_cuda if r.is_cuda else engine_layer_plain
    return fn(r, layer, mode, **kw)
