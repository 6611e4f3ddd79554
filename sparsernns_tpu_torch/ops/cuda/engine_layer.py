"""Kernels K5a / K5b: one quantized serving layer in one kernel.

Replaces ``sparsernns_tpu/ops/pallas/fused_layer.py`` ``fused_layer_apply``
(K5a) and ``fused_layer_apply_carry`` (K5b, with a carry in and out), in
float-dot mode and in the integer-dot modes. Per batch row, over a residual
stream stored as the integer codes of its frozen grid (int16 / int8), bf16
or f32::

    r  = stream * in_requant scale
    z  = r * nw + nb                       (prenorm; else z = r)
    bu = (z @ W_b) * wb_scales             (int8 / int16 / f32 weights)
    xs = scan(lam, bu), requantized onto block_requant per time block
    y  = [xs_re * wc_re | xs_im * wc_im] @ W_c + d * z    (relu on xs)
    x1 = relu(y) or gelu(y);  h = GLU(x1, y) + r
    (postnorm) -> relu if relufication -> codes of out_requant

**Integer dots** (``ops/intdot.py``; the JAX kernels' ``_glu_dense``,
``_mixer_pre`` and ``_mixer_post``): a dense with a frozen input grid
(:class:`Dense` ``in_spec``: the GLU denses, the encoder and the decoder)
runs on the codes of its operand, one int8 plane at 8 bits or fewer (w8a8)
and two at 9..16 bits (w8a16 with ``mxu16``), and requantizes its output
after the bias onto ``out_spec``; a layer's ``mixer_in16`` runs the
B-projection on the codes of the mixer input (the D term takes the same
codes), ``state16`` the C-projection on the states' codes, and
``but_requant`` / ``yt_requant`` requantize the B-projection and the mixer
output. The two-plane formula is picked from the reduction dim the TPU
kernels see, which pad H and P to 128 (:func:`pad128`) but not the
encoder's input.

**The time block is numerics.** ``block_t`` frames form one block: inside
it the recurrence runs on unquantized float32, after it every state of the
block is requantized and the requantized last state is the carry into the
next block. The caller passes the effective block of its route.

The serving stack's first launch may run the encoder dense before the
layer (``enc``) and its last launch the decoder dense after it (``dec``),
so that the stack route sums every product exactly as the whole-network
kernel does (``engine_network.py``) and the two stay bit-identical.

**Passes.** On the card a call is three kernels over the whole card
(``csrc/engine_passes.cuh``), enqueued by one C call: a row pass over
tiles of :data:`ROW_TILE` frames of the flattened B * L stream (the
stream, or the encoder, then the layer's head: bu), the scan (a thread per
(batch row, state channel), all L in order, the carry in and out), and a
row pass (the layer's tail, then the stream's codes or the decoder).
:func:`pass_plan` gives the tiles, grids and scratch of a call, a pure
function of the shapes; :func:`launched` reads back what ran.

The CUDA source is ``csrc/engine_layer.cu`` over ``csrc/engine_passes.cuh``
and ``csrc/engine_body.cuh``. :func:`engine_layer` launches the passes for
CUDA tensors (or raises) and takes the plain version
:func:`engine_layer_plain` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sparsernns_tpu_torch.ops.cuda import build
from sparsernns_tpu_torch.ops.intdot import (DOT_I8, dot_formula, int16_dot,
                                             quantize_codes)
from sparsernns_tpu_torch.ops.scan import (Pair, grid_value, quant_codes,
                                           sequential_diag_scan)
from sparsernns_tpu_torch.utils.trace import count, traced

GLU_KINDS = ("full", "half1", "half2", "none")

#: frames of the flattened B * L stream that one row-pass CTA owns (``kT``
#: of ``csrc/engine_body.cuh``)
ROW_TILE = 32
#: state channels of one scan CTA (``kScanThreads`` of
#: ``csrc/engine_passes.cuh``)
SCAN_CHANNELS = 32
ROW_PASS = "engine_row_pass_kernel"
SCAN_PASS = "engine_scan_pass_kernel"

Spec = Optional[Tuple[float, int]]


class Dense(NamedTuple):
    """A dense layer as the kernels take it."""

    #: QWeight-like: ``.data`` (in, out), ``.scale`` (None: float data),
    #: ``.colsum`` (out,) int32 column sums of int8 data, ``.frags`` the
    #: tensor cores' fragments of int8 data (:func:`attach_fragments`)
    kernel: Any
    bias: torch.Tensor
    #: (scale, bits) frozen grid of the input: the dot runs on its codes
    #: (int8 weights with a scale only); None: a float dot
    in_spec: Spec = None
    #: (scale, bits) requant of the output after the bias; None: none
    out_spec: Spec = None


def pad128(k: int) -> int:
    """A lane dim as the TPU kernels pad it; the two-plane formula of an
    integer dot is picked from it."""
    return -(-k // 128) * 128


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


def int_dot_spec(kernel, in_spec: Spec) -> Spec:
    """The input grid a dense's dot runs on: ``in_spec`` for an int8
    weight with a scale, else None (a float dot), as JAX's
    ``quantized_dense`` decides."""
    if (in_spec is None or kernel.scale is None
            or kernel.data.dtype != torch.int8):
        return None
    return in_spec


def dense_plain(x: torch.Tensor, dense: Dense,
                k_dot: Optional[int] = None) -> torch.Tensor:
    """(x @ W as float32) * weight scale + bias, or with an input grid the
    integer dot of x's codes times (input scale * weight scale) + bias;
    then the output requant. ``k_dot``: the reduction dim that picks the
    two-plane formula (default: x's last dim)."""
    kernel = dense.kernel
    spec = int_dot_spec(kernel, dense.in_spec)
    if spec is None:
        r = x @ kernel.data.to(torch.float32)
        if kernel.scale is not None:
            r = r * kernel.scale
    else:
        s, bits = spec
        acc = int16_dot(x, kernel.data, kernel.colsum, s, bits,
                        reduction_dim=k_dot)
        r = acc * (s * kernel.scale)
    return qdq(r + dense.bias, dense.out_spec)


#: depth of one tensor-core k-step (mma m16n8k16) and the columns of one
#: group of a warp's n-blocks in ``tile_matmul_mma`` (csrc/engine_body.cuh)
MMA_K = 16
MMA_GROUP = 32


def mma_k_order(k0: int) -> List[int]:
    """The k that each of mma's 16 k slots takes in the step from ``k0``:
    lane t's slots 2t, 2t + 1, 2t + 8, 2t + 9 hold k0 + 4t .. k0 + 4t + 3,
    in A and in B alike."""
    return [k0 + 4 * ((s % 8) // 2) + s % 2 + 2 * (s // 8)
            for s in range(MMA_K)]


def mma_columns(group: int, j: int) -> List[int]:
    """The output columns of n-block ``j`` (0..3) of a 32-column group, by
    mma's n index: n -> 32 * group + 4n + j, so that lane (g, t) holds
    columns 8t .. 8t + 7 of the group."""
    return [MMA_GROUP * group + 4 * n + j for n in range(8)]


def mma_fragments(w: torch.Tensor) -> torch.Tensor:
    """An int8 weight (K, N) as the B operands of the kernel's tensor-core
    products (``DenseW.wf``): bf16 codes (exact), K padded with zero codes
    to a multiple of 16 and N to 32, laid out (column group, k-step, lane
    (g, t), n-block j, register q, half h) so that each lane loads its
    fragments of one group and step as 32 contiguous bytes; the half h of
    register q of n-block j is the code at k = 16 * step + 4t + 2q + h,
    column 32 * group + 4g + j (:func:`mma_k_order`, :func:`mma_columns`).
    """
    k, n = w.shape
    steps, groups = -(-k // MMA_K), -(-n // MMA_GROUP)
    wp = F.pad(w.to(torch.bfloat16),
               (0, groups * MMA_GROUP - n, 0, steps * MMA_K - k))
    # k -> (step, t, q, h), column -> (group, g, j)
    return (wp.reshape(steps, 4, 2, 2, groups, 8, 4)
            .permute(4, 0, 5, 1, 6, 2, 3).contiguous())


def tile_mma_plain(a: torch.Tensor, w: torch.Tensor,
                   acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain mirror of the kernel's tensor-core products of an int8 float
    dot: ``a`` (M, K) float32, ``w`` (K, N) int8 -> (M, N). For each n-block
    of each 32-column group (:func:`mma_columns`), each 16-deep k-step (K
    padded with zeros) in the kernel's k order: the products of a's three
    split planes (K7's ``block_sparse.split_f32``; lo, mid, hi) summed into
    the step's sums, which are then added to the block's running sums, in
    ``acc_dtype``.
    Every plane product is exact; the tensor cores round each 16-term sum
    their own way, so in float32 the mirror repeats the order, not the
    bits, and in float64 (exact for operands of a bounded exponent range)
    it is the float64 dot."""
    from sparsernns_tpu_torch.ops.cuda.block_sparse import split_f32
    m, k = a.shape
    n = w.shape[1]
    k_pad = -(-k // MMA_K) * MMA_K
    n_pad = -(-n // MMA_GROUP) * MMA_GROUP
    planes = [p.to(acc_dtype) for p in split_f32(
        F.pad(a.to(torch.float32), (0, k_pad - k)))]
    wp = F.pad(w.to(acc_dtype), (0, n_pad - n, 0, k_pad - k))
    out = torch.zeros((m, n_pad), dtype=acc_dtype, device=a.device)
    for group in range(n_pad // MMA_GROUP):
        for j in range(4):
            cols = mma_columns(group, j)
            acc = torch.zeros((m, len(cols)), dtype=acc_dtype,
                              device=a.device)
            for k0 in range(0, k_pad, MMA_K):
                ks = mma_k_order(k0)
                step = torch.zeros_like(acc)
                for p in reversed(planes):
                    step += p[:, ks] @ wp[ks][:, cols]
                acc += step
            out[:, cols] = acc
    return out[:, :n]


def stream_value(h: torch.Tensor, layer, mode: LayerMode) -> torch.Tensor:
    """What the next reader of the stream sees of a layer's output h:
    storing the codes (or the activation type) and loading them again."""
    if layer.residual_requant is not None:
        return qdq(h, layer.residual_requant)
    return h.to(mode.act_dtype).to(torch.float32)


def encode_plain(x: torch.Tensor, enc: Dense, mode: LayerMode
                 ) -> torch.Tensor:
    h = dense_plain(x.to(torch.float32), enc)      # K = d_in, unpadded
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
    #: integer-dot modes (module docstring); the mixer kernel K4a keeps
    #: them off
    mixer_in16: Spec = None
    state16: bool = False
    but_requant: Optional[Tuple[float, float, int]] = None
    yt_requant: Spec = None
    cs_wb: Optional[torch.Tensor] = None      # (2P,) int32
    cs_wc_re: Optional[torch.Tensor] = None   # (H,) int32
    cs_wc_im: Optional[torch.Tensor] = None
    #: the tensor cores' fragments of int8 W_b and W_c
    #: (:func:`attach_fragments`); None: their products as fmaf chains
    wb_frags: Optional[torch.Tensor] = None
    wc_frags: Optional[torch.Tensor] = None


def mixer_plain(z: torch.Tensor, layer, relu_state: bool, carry: Pair
                ) -> Tuple[torch.Tensor, Pair]:
    """The mixer on ONE time block z (B, T, H) float32 from ``carry``:
    B-projection with the per-half scales (on the codes of z with
    ``mixer_in16``), quant_but, the recurrence, every state on the frozen
    grid and the requantized last state as the next carry, relu,
    C-projection (per half on the states' codes with ``state16``) + d * z
    (d * the codes' values with ``mixer_in16``), quant_yt. Returns (y,
    carry)."""
    h = layer.w_b.shape[0]
    p = layer.w_b.shape[-1] // 2
    if layer.mixer_in16 is not None:
        s_ut, bits = layer.mixer_in16
        q_ut = quantize_codes(z, s_ut, bits)
        acc = int16_dot(z, layer.w_b, layer.cs_wb, s_ut, bits, codes=q_ut,
                        reduction_dim=pad128(h))
        bu_re = acc[..., :p] * (s_ut * layer.wb_scales[0])
        bu_im = acc[..., p:] * (s_ut * layer.wb_scales[1])
        z = q_ut * s_ut
    else:
        bu = z @ layer.w_b.to(torch.float32)
        bu_re, bu_im = bu[..., :p], bu[..., p:]
        if layer.wb_scales is not None:
            bu_re = bu_re * layer.wb_scales[0]
            bu_im = bu_im * layer.wb_scales[1]
    if layer.but_requant is not None:
        s_br, s_bi, bits = layer.but_requant
        bu_re, bu_im = qdq(bu_re, (s_br, bits)), qdq(bu_im, (s_bi, bits))
    (x_re, x_im), _ = sequential_diag_scan(layer.lam, (bu_re, bu_im), carry)
    if layer.state_requant is not None:
        s_re, s_im, bits = layer.state_requant
        x_re, x_im = qdq(x_re, (s_re, bits)), qdq(x_im, (s_im, bits))
    carry = (x_re[:, -1], x_im[:, -1])
    if relu_state:
        x_re, x_im = torch.relu(x_re), torch.relu(x_im)
    if layer.state16:
        # the states lie on the block-requant grid: their codes are one
        # exact multiply
        s_re, s_im, bits = layer.state_requant
        k = pad128(p)
        acc_re = int16_dot(None, layer.w_c[:p], layer.cs_wc_re, s_re, bits,
                           codes=x_re * (1.0 / s_re), reduction_dim=k)
        acc_im = int16_dot(None, layer.w_c[p:], layer.cs_wc_im, s_im, bits,
                           codes=x_im * (1.0 / s_im), reduction_dim=k)
        y = (acc_re * (s_re * layer.wc_scales[0])
             + acc_im * (s_im * layer.wc_scales[1]))
    else:
        if layer.wc_scales is not None:
            x_re, x_im = (x_re * layer.wc_scales[0],
                          x_im * layer.wc_scales[1])
        y = torch.cat([x_re, x_im], dim=-1) @ layer.w_c.to(torch.float32)
    return qdq(y + layer.d * z, layer.yt_requant), carry


def glu_denses(layer) -> Tuple[Dense, Dense]:
    """The gate dense and the value dense of a layer with their grids."""
    return (Dense(layer.out2_kernel, layer.out2_bias, layer.out2_in_scale,
                  layer.out2_out_requant),
            Dense(layer.out1_kernel, layer.out1_bias, layer.out1_in_scale,
                  layer.out1_out_requant))


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
        out2, out1 = glu_denses(layer)
        k = pad128(x1.shape[-1])
        gate = torch.sigmoid(dense_plain(x1, out2, k))
        if mode.glu == "half1":
            base = x1
        elif mode.glu == "half2":
            base = y
        else:
            base = dense_plain(x1, out1, k)
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
    width = (enc.kernel.data.shape[0] if enc is not None
             else layer.w_b.shape[0])
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
            out = dense_plain(stream_value(h, layer, mode), dec,
                              pad128(h.shape[-1]))
            outs.append(out.to(out_dtype))
        elif layer.residual_requant is not None:
            outs.append(quant_codes(h, layer.residual_requant).to(
                stream_dtype(layer, mode)))
        else:
            outs.append(h.to(mode.act_dtype))
    out = torch.cat(outs, dim=1)
    return out if carry is None else (out, state)


# ----------------------------------------------------------------- plan

@dataclasses.dataclass(frozen=True)
class PassPlan:
    """How K5 and K6 cut one call over the card: ``n_layers + 1`` row
    passes, each over tiles of :data:`ROW_TILE` consecutive frames of the
    flattened (B * L) stream (a tile may straddle two batch rows: nothing
    in a row pass is per sequence), and before each but the first a scan
    of one layer, a thread per (batch row, state channel) in CTAs of
    :data:`SCAN_CHANNELS` channels of one batch row. ``p``: the widest
    layer's state channels; ``encoder``: whether the first pass runs the
    encoder, whose output the later passes then read from scratch."""

    batch: int
    length: int
    h: int
    p: int
    n_layers: int
    encoder: bool = True

    @property
    def rows(self) -> int:
        return self.batch * self.length

    @property
    def row_ctas(self) -> int:
        return -(-self.rows // ROW_TILE)

    @property
    def scan_ctas(self) -> int:
        return self.batch * -(-self.p // SCAN_CHANNELS)

    def tiles(self) -> List[Tuple[int, int]]:
        """(first row, end row) of the flattened stream, per row-pass CTA
        in grid order."""
        return [(r0, min(r0 + ROW_TILE, self.rows))
                for r0 in range(0, self.rows, ROW_TILE)]

    def channels(self) -> List[Tuple[int, int]]:
        """(batch row, channel) of every scan thread that walks one, CTA by
        CTA in grid order."""
        groups = -(-self.p // SCAN_CHANNELS)
        return [(cta // groups, p)
                for cta in range(self.scan_ctas)
                for p in range((cta % groups) * SCAN_CHANNELS,
                               min((cta % groups + 1) * SCAN_CHANNELS,
                                   self.p))]

    def passes(self) -> List[Tuple[str, int]]:
        """(kernel, CTAs) of every launch of the call, in order."""
        out = [(ROW_PASS, self.row_ctas)]
        for _ in range(self.n_layers):
            out += [(SCAN_PASS, self.scan_ctas), (ROW_PASS, self.row_ctas)]
        return out

    def scratch_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The float32 scratch between the passes: ``bu`` (bu, then the
        scan's raw states, one layer at a time, in place) and, after an
        encoder, ``stream`` (the stream values, in place)."""
        shapes = {"bu": (self.rows, 2 * self.p)}
        if self.encoder:
            shapes["stream"] = (self.rows, self.h)
        return shapes

    def scratch_bytes(self) -> int:
        return 4 * sum(a * b for a, b in self.scratch_shapes().values())


def pass_plan(batch: int, length: int, h: int, p: int, n_layers: int,
              encoder: bool = True) -> PassPlan:
    """The plan of one K5 (``n_layers`` 1) or K6 call, a pure function of
    the shapes."""
    if min(batch, length, h, p, n_layers) < 1:
        raise ValueError(f"empty call: B={batch}, L={length}, H={h}, P={p}, "
                         f"{n_layers} layers")
    return PassPlan(batch, length, h, p, n_layers, encoder)


def alloc_scratch(plan: PassPlan, device) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(v, dtype=torch.float32, device=device)
            for k, v in plan.scratch_shapes().items()}


# ----------------------------------------------------------------- CUDA

class DenseW(ctypes.Structure):
    """``engine::DenseW`` of ``csrc/engine_body.cuh``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("w", "bias", "colsum",
                                                  "wf")]
                + [(n, ctypes.c_float)
                   for n in ("scale", "acc_scale", "in_s", "out_s")]
                + [(n, ctypes.c_int)
                   for n in ("wtype", "in_mode", "in_bits", "out_bits")])


class LayerParams(ctypes.Structure):
    """``engine::LayerParams`` of ``csrc/engine_body.cuh``."""

    _fields_ = (
        [(n, ctypes.c_void_p)
         for n in ("lam_re", "lam_im", "d", "nw", "nb", "cs_wb", "cs_wc_re",
                   "cs_wc_im")]
        + [(n, DenseW) for n in ("wb", "wc", "out2", "out1")]
        + [(n, ctypes.c_float)
           for n in ("wb_s_re", "wb_s_im", "wc_s_re", "wc_s_im", "sq_re",
                     "sq_im", "sq_min", "sq_max", "rq_s", "rq_min",
                     "rq_max", "ut_s", "ut_sc_re", "ut_sc_im", "st_inv_re",
                     "st_inv_im", "st_sc_re", "st_sc_im", "but_re",
                     "but_im", "yt_s")]
        + [(n, ctypes.c_int) for n in (
            "has_sq", "has_rq", "p", "ut_mode", "ut_bits", "st_mode",
            "but_bits", "yt_bits")])


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


def _bits(spec, name: str) -> int:
    """The width of a grid the kernels quantize onto: at most 16 bits."""
    bits = int(spec[-1])
    if not 1 < bits <= 16:
        raise ValueError(f"{name}: a {bits}-bit grid in the kernel")
    return bits


def _colsum(t: Optional[torch.Tensor], name: str, n: int, device) -> int:
    if t is None:
        raise ValueError(f"{name}: a two-plane dot needs its column sums")
    return _ptr(t, name, (n,), torch.int32, device)


def pack_weight(w: torch.Tensor, scale: Optional[float],
                bias: Optional[torch.Tensor], name: str, shape,
                device, frags: Optional[torch.Tensor] = None) -> DenseW:
    """A weight as the kernel's struct. An int8 weight's float dot runs on
    the tensor cores where it comes with its fragments (``frags``,
    :func:`attach_fragments`), else as fmaf chains."""
    if w.dtype not in WTYPES:
        raise ValueError(f"{name}: weight dtype {w.dtype}")
    out = DenseW()
    out.w = _ptr(w, name, shape, w.dtype, device)
    out.bias = (None if bias is None else
                _ptr(bias, f"{name} bias", (shape[1],), torch.float32,
                     device))
    out.scale = 1.0 if scale is None else float(scale)
    out.wtype = WTYPES[w.dtype]
    if frags is not None:
        if w.dtype != torch.int8:
            raise ValueError(f"{name}: fragments of a {w.dtype} weight")
        out.wf = _ptr(frags, f"{name} fragments",
                      fragments_shape(*shape), torch.bfloat16, device)
    return out


def pack_dense(dense: Optional[Dense], name: str, shape, device,
               k_dot: Optional[int] = None) -> DenseW:
    """A dense as the kernel's struct, with its integer dot (formula from
    ``k_dot``, default the input width) and its output requant."""
    if dense is None:
        return DenseW()
    kernel = dense.kernel
    spec = int_dot_spec(kernel, dense.in_spec)
    out = pack_weight(kernel.data, kernel.scale, dense.bias, name, shape,
                      device, getattr(kernel, "frags", None)
                      if spec is None else None)
    if spec is not None:
        s, bits = float(spec[0]), _bits(spec, f"{name} input")
        out.in_mode = dot_formula(shape[0] if k_dot is None else k_dot, bits)
        out.in_s, out.in_bits = s, bits
        out.acc_scale = s * kernel.scale
        if out.in_mode != DOT_I8:
            out.colsum = _colsum(kernel.colsum, f"{name} colsum", shape[1],
                                 device)
    if dense.out_spec is not None:
        out.out_s = float(dense.out_spec[0])
        out.out_bits = _bits(dense.out_spec, f"{name} output")
    return out


def pack_mixer(layer, device) -> LayerParams:
    """The mixer's operands of a layer (or a :class:`MixerOps`) as the
    kernel's struct, without the norm and the GLU (pointers into the
    layer's own tensors, which must outlive the launch); int8 B- and
    C-projections with their fragments on the tensor cores."""
    h = layer.w_b.shape[0]
    p = layer.w_b.shape[-1] // 2
    f32 = torch.float32
    lp = LayerParams()
    lp.lam_re = _ptr(layer.lam[0], "lam_re", (p,), f32, device)
    lp.lam_im = _ptr(layer.lam[1], "lam_im", (p,), f32, device)
    lp.d = _ptr(layer.d, "d", (h,), f32, device)
    lp.wb = pack_weight(layer.w_b, None, None, "w_b", (h, 2 * p), device,
                        layer.wb_frags)
    lp.wc = pack_weight(layer.w_c, None, None, "w_c", (2 * p, h), device,
                        layer.wc_frags)
    lp.wb_s_re, lp.wb_s_im = layer.wb_scales or (1.0, 1.0)
    lp.wc_s_re, lp.wc_s_im = layer.wc_scales or (1.0, 1.0)
    if layer.state_requant is not None:
        s_re, s_im, bits = layer.state_requant
        lp.has_sq, lp.sq_re, lp.sq_im = 1, s_re, s_im
        lp.sq_min, lp.sq_max = -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1
    if layer.mixer_in16 is not None:
        if layer.w_b.dtype != torch.int8 or layer.wb_scales is None:
            raise ValueError("mixer_in16 needs int8 W_b with its scales")
        s_ut = float(layer.mixer_in16[0])
        lp.ut_bits = _bits(layer.mixer_in16, "mixer_in16")
        lp.ut_mode = dot_formula(pad128(h), lp.ut_bits)
        lp.ut_s = s_ut
        lp.ut_sc_re = s_ut * layer.wb_scales[0]
        lp.ut_sc_im = s_ut * layer.wb_scales[1]
        if lp.ut_mode != DOT_I8:
            lp.cs_wb = _colsum(layer.cs_wb, "cs_wb", 2 * p, device)
    if layer.state16:
        if (layer.w_c.dtype != torch.int8 or layer.wc_scales is None
                or layer.state_requant is None):
            raise ValueError("state16 needs int8 W_c with its scales and "
                             "the state requant")
        s_re, s_im, _ = layer.state_requant
        bits = _bits(layer.state_requant, "state16")
        lp.st_mode = dot_formula(pad128(p), bits)
        lp.st_inv_re, lp.st_inv_im = 1.0 / s_re, 1.0 / s_im
        lp.st_sc_re = s_re * layer.wc_scales[0]
        lp.st_sc_im = s_im * layer.wc_scales[1]
        if lp.st_mode != DOT_I8:
            lp.cs_wc_re = _colsum(layer.cs_wc_re, "cs_wc_re", h, device)
            lp.cs_wc_im = _colsum(layer.cs_wc_im, "cs_wc_im", h, device)
    if layer.but_requant is not None:
        lp.but_re, lp.but_im = layer.but_requant[:2]
        lp.but_bits = _bits(layer.but_requant, "but_requant")
    if layer.yt_requant is not None:
        lp.yt_s = layer.yt_requant[0]
        lp.yt_bits = _bits(layer.yt_requant, "yt_requant")
    lp.p = p
    return lp


def attach_fragments(enc: Optional[Dense], layers: Sequence,
                     dec: Optional[Dense], mode: LayerMode) -> bool:
    """Lay out once the tensor cores' B fragments (:func:`mma_fragments`)
    of every int8 weight of a serving network whose dot is a float dot:
    the encoder, each layer's B- and C-projection and GLU denses, the
    decoder. They are kept beside the weight (``kernel.frags``, a layer's
    ``wb_frags`` / ``wc_frags``), where :func:`pack_dense` and
    :func:`pack_mixer` hand them to the kernels: those products run on the
    tensor cores, on every route that packs these weights. One rule for
    the whole network: where any dense of it runs an integer dot (w8a8,
    mxu16), none gets fragments (any it had are dropped), and its float
    dots stay fmaf chains, bit for bit as before the tensor cores: the
    order of a sum moves codes of the 8-bit grids after it by more than
    the engine bar. Returns whether the network has fragments."""
    used = {"full": 2, "half1": 1, "half2": 1, "none": 0}[mode.glu]
    # the denses over a QWeight (a block-sparse weight is K7's, outside)
    denses = [d for d in (enc, dec) if d is not None]
    for layer in layers:
        denses += glu_denses(layer)[:used]
    denses = [d for d in denses if hasattr(d.kernel, "frags")]
    tensor_cores = not (
        any(layer.mixer_in16 is not None or layer.state16
            for layer in layers)
        or any(int_dot_spec(d.kernel, d.in_spec) is not None
               for d in denses))

    def frags(w: torch.Tensor) -> Optional[torch.Tensor]:
        return (mma_fragments(w) if tensor_cores and w.dtype == torch.int8
                else None)

    for d in denses:
        d.kernel.frags = frags(d.kernel.data)
    for layer in layers:
        layer.wb_frags = frags(layer.w_b)
        layer.wc_frags = frags(layer.w_c)
    return tensor_cores


def fragments_shape(k: int, n: int) -> Tuple[int, ...]:
    """The shape of :func:`mma_fragments` of a (k, n) weight."""
    return (-(-n // MMA_GROUP), -(-k // MMA_K), 8, 4, 4, 2, 2)


def pack_layer(layer, mode: LayerMode, device) -> LayerParams:
    """One layer's operands as the kernel's struct (pointers into the
    layer's own tensors, which must outlive the launch)."""
    h = layer.w_b.shape[0]
    f32 = torch.float32
    lp = pack_mixer(layer, device)
    lp.nw = _ptr(layer.norm_w, "norm_w", (h,), f32, device)
    lp.nb = _ptr(layer.norm_b, "norm_b", (h,), f32, device)
    out2, out1 = glu_denses(layer)
    if mode.glu != "none":
        lp.out2 = pack_dense(out2, "out2", (h, h), device, pad128(h))
    if mode.glu == "full":
        lp.out1 = pack_dense(out1, "out1", (h, h), device, pad128(h))
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


#: bytes of shared memory a block may opt in to on the H100 (227 KB)
MAX_SMEM = 232448


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _code_width(lp: LayerParams, h: int) -> int:
    """``code_width`` of ``csrc/engine_body.cuh``: bytes a row of the code
    tile needs for a layer's integer dots."""
    w = h if (lp.ut_mode or lp.out2.in_mode or lp.out1.in_mode) else 0
    if lp.st_mode:
        w = max(w, 2 * _round4(lp.p))
    return w


def row_pass_smem(h: int, ld_bu: int, *, d_in: int = 0,
                  tail: Optional[LayerParams] = None,
                  head: Optional[LayerParams] = None,
                  enc: Optional[DenseW] = None, dec: Optional[DenseW] = None,
                  y_out: bool = False) -> int:
    """Bytes of dynamic shared memory one row pass takes: ``row_pass_smem``
    of ``csrc/engine_passes.cuh`` (with ``pass_ldq``, ``union_width`` and
    ``q_in_s``) over the packed structs of the pass: the layer whose tail
    and the layer whose head it runs, the encoder and the decoder (None or
    a struct without ``w``: absent), ``y_out`` for the mixer alone."""
    has_enc = enc is not None and bool(enc.w)
    has_dec = dec is not None and bool(dec.w)
    ldh, ldp = _round4(h), _round4(ld_bu)
    q_w = d_in if has_enc and enc.in_mode else 0
    if has_dec and dec.in_mode:
        q_w = max(q_w, h)
    for lp in (tail, head):
        if lp is not None:
            q_w = max(q_w, _code_width(lp, h))
    ldq = _round4(q_w)
    union = max(ldh + ldp if tail is not None else 0,
                _round4(d_in) if has_enc else 0)
    q_in_s = tail is not None and 2 * ldq <= 4 * ldp
    return (4 * ROW_TILE * ((1 if y_out else 2) * ldh + union)
            + (0 if q_in_s else 2 * ROW_TILE * ldq))


@functools.lru_cache(maxsize=256)
def widest_row_pass(h: int, p: int, d_in: int) -> int:
    """An upper bound of :func:`row_pass_smem` over every pass a K5 / K6
    call of these widths can launch (layers of at most ``p`` states, the
    state row ``2 * p``): two row tiles and the widest union, and the
    widest code tile beside them. Cached: a call whose bound fits skips
    the exact count of :func:`check_row_passes`."""
    ldh = _round4(h)
    union = max(ldh + _round4(2 * p), _round4(d_in))
    ldq = _round4(max(d_in, h, 2 * _round4(p)))
    return 4 * ROW_TILE * (2 * ldh + union) + 2 * ROW_TILE * ldq


def check_row_passes(h: int, ld_bu: int, passes) -> None:
    """Raise ValueError, before any launch, where a row pass of a K5 / K6
    call (``passes``: keyword dicts of :func:`row_pass_smem`) needs more
    shared memory than a block may opt in to: H above 520 at P = 128 with
    float dots, above 512 with integer dots."""
    for i, kw in enumerate(passes):
        smem = row_pass_smem(h, ld_bu, **kw)
        if smem > MAX_SMEM:
            raise ValueError(
                f"H={h}, state row {ld_bu}: row pass {i} needs {smem} bytes "
                f"of shared memory, the card gives {MAX_SMEM}")


_FWD_ARGS = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_float, ctypes.POINTER(LayerParams),
              ctypes.POINTER(Mode), ctypes.POINTER(DenseW), ctypes.c_int,
              ctypes.POINTER(DenseW), ctypes.c_int]
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 3)
#: the argument types of a library's ``<lib>_launched`` and
#: ``<lib>_launched_dots``
_RECORD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]


def read_launched(lib_name: str) -> List[Tuple[str, int]]:
    """(kernel, CTAs) of every pass that the last call of the library's
    entry launched on the card, in order, as its CUDA source recorded
    them at the launch."""
    fn = build.entry(lib_name, f"{lib_name}_launched", _RECORD_ARGS)
    cap = 2 * 8 + 1
    names = (ctypes.c_char_p * cap)()
    ctas = (ctypes.c_longlong * cap)()
    n = fn(names, ctas, cap)
    return [(names[i].decode(), ctas[i]) for i in range(min(n, cap))]


def read_launched_dots(lib_name: str) -> List[Tuple[int, int]]:
    """(on the tensor cores, as fmaf tiles): the float-dot dense products
    of every pass of the last call of the library's entry, in the order of
    :func:`read_launched` (0, 0 for a scan). A dense of int8 codes with
    their fragments (:func:`attach_fragments`) runs on the tensor cores,
    any other float dot as fmaf tiles; an integer dot is neither."""
    fn = build.entry(lib_name, f"{lib_name}_launched_dots", _RECORD_ARGS)
    cap = 2 * 8 + 1
    mma = (ctypes.c_int * cap)()
    fmaf = (ctypes.c_int * cap)()
    n = fn(mma, fmaf, cap)
    return [(mma[i], fmaf[i]) for i in range(min(n, cap))]


def launched() -> List[Tuple[str, int]]:
    """The passes of the last K5a / K5b call on the card: see
    :func:`read_launched`."""
    return read_launched("engine_layer")


@traced("kernel.engine_layer")
def engine_layer_cuda(r: torch.Tensor, layer, mode: LayerMode, *,
                      block_t: int,
                      in_requant: Optional[Tuple[float, int]] = None,
                      carry: Optional[Pair] = None,
                      enc: Optional[Dense] = None,
                      dec: Optional[Dense] = None,
                      out_dtype: torch.dtype = torch.float32):
    """Enqueue the three passes (:func:`pass_plan`). Same arguments and
    results as :func:`engine_layer_plain`; every tensor on ``r``'s CUDA
    device."""
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
    d_in = enc.kernel.data.shape[0] if enc is not None else 0
    d_out = dec.kernel.data.shape[1] if dec is not None else 0
    o_dtype = out_dtype if dec is not None else stream_dtype(layer, mode)
    out = torch.empty((b, l, d_out if dec is not None else h),
                      dtype=o_dtype, device=dev)
    lp = pack_layer(layer, mode, dev)
    md = pack_mode(mode, h)
    enc_w = pack_dense(enc, "encoder", (d_in, h), dev)
    dec_w = pack_dense(dec, "decoder", (h, d_out), dev, pad128(h))
    if widest_row_pass(h, p, d_in) > MAX_SMEM:
        check_row_passes(h, 2 * p, [dict(d_in=d_in, head=lp, enc=enc_w),
                                    dict(d_in=d_in, tail=lp, dec=dec_w)])
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
    scratch = alloc_scratch(pass_plan(b, l, h, p, 1, enc is not None), dev)
    err = build.entry("engine_layer", "engine_layer_fwd", _FWD_ARGS)(
        r.data_ptr(), out.data_ptr(), IO_TYPES[r.dtype], IO_TYPES[o_dtype],
        1.0 if in_requant is None else float(in_requant[0]),
        ctypes.byref(lp), ctypes.byref(md), ctypes.byref(enc_w), d_in,
        ctypes.byref(dec_w), d_out, *ci_ptr, *co_ptr, b, l, int(block_t),
        scratch["bu"].data_ptr(),
        scratch["stream"].data_ptr() if "stream" in scratch else None,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "engine_layer")
    if carry is None:
        count("engine_layer")
        return out
    count("engine_layer_carry")
    return out, co


def engine_layer(r: torch.Tensor, layer, mode: LayerMode, **kw):
    """One serving layer over the stored stream. CUDA tensors launch the
    passes (or raise); CPU tensors take the plain version."""
    fn = engine_layer_cuda if r.is_cuda else engine_layer_plain
    return fn(r, layer, mode, **kw)
