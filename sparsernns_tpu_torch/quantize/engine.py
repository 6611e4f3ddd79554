"""W8A16 serving engine: the quantized inference path as GPU kernels
(counterpart of ``sparsernns_tpu/quantize/engine.py``).

- weights are stored quantized (int8 for B̄/C/dense, values on the pow2
  grid for Λ̄ and D) with frozen power-of-2 scales from calibration, packed
  once, host-side, into the kernels' layouts;
- activations run at 16 bits: the residual stream between layers is the
  int16 codes of each layer's calibrated grid (int8 at 8 bits, bf16 where
  a layer has none), the scan state float32;
- integer dots (``ops/intdot.py``): with activations of 8 bits or fewer
  (w8a8) the GLU denses, the encoder and the decoder run as int8 x int8 ->
  int32 dots on the codes of their frozen ``quant_input`` grids; with
  ``mxu16=True`` a w8a16 engine runs every dot site so, on the two int8
  planes of its 16-bit codes (the B-projection on the ``quant_ut`` codes,
  the C-projection on the state codes, the denses), and applies the
  frozen ``quant_but``, ``quant_yt`` and ``quant_output`` requants of the
  static-quant model. In the kernels these are the integer-dot modes of
  K5/K6; on the per-op route ``quantized_dense`` runs them (the per-op
  route serves no ``mxu16``: the JAX engine demotes it there);
- the offline call runs the whole network as ONE kernel
  (``ops/cuda/engine_network.py``, K6), or one kernel per layer
  (``ops/cuda/engine_layer.py``, K5a) when the network route is switched
  off; a streaming chunk runs one kernel per layer with carries (K5b).
  The two offline routes are bit-identical at the same time block;
- what the whole-layer kernels cannot express (model-dim activation
  top-k, a residual requant wider than 16 bits, a block-sparse GLU dense)
  runs the per-op route, decided by configuration
  (:meth:`W8A16Engine._fused_stack_eligible`): the mixer is one kernel
  (``ops/cuda/fused_s5.py`` ``fused_s5_engine``: K4a's engine modes
  offline, K4b with carries per chunk), or with top-k on the relufied
  states the B-projection, the scan kernel with its block requant
  (``ops/scan.py`` ``diag_ssm_scan``, K1) and the C-projection; norm,
  activation, GLU, residual, top-k and the dense layers are tensor ops
  around it (``engine_layer_forward``), the denses as ``torch.matmul`` of
  the dequantized weights, as the JAX package leaves them to XLA;
- a dense kernel with enough all-zero (32, 128) tiles (a tile-pruned
  checkpoint) is packed block-sparse and runs the block-sparse matmul
  (``ops/cuda/block_sparse.py``, K7) wherever it is used; a block-sparse
  encoder or decoder turns the whole-network route off, and the stack
  route then runs it outside the first or last layer launch;
- ``route="xla"`` (only when the caller asks for it; ``"auto"`` never
  takes it) runs no kernel at all, as the JAX package made it: the per-op
  route with every dense dequantized to a float ``torch.matmul`` (no
  integer dots, no block-sparse packs, no mxu16 requants) and the mixer
  as the B-projection, the block-parallel matmul scan
  (``ops/scan.py`` ``blocked_diag_scan``, with the per-block state
  requant and, per chunk, the layer's carry) and the C-projection. The
  state and residual requants keep their static-quant semantics.

The engine takes the frozen tree that calibration returns
(``quantize/calibrate.py``, or the JAX package's: the trees are
interchangeable), as nested dicts of numpy arrays, or reads the one that
the conversion pipeline stored (:meth:`W8A16Engine.from_artifacts`).

Refused with ``NotImplementedError``, as in the JAX package: chunked
streaming with top-k on the states. The sequence- and pipeline-parallel
engines of ``parallel/`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparsernns_tpu_torch.fxp.derive import FxpModelConfig, _discretize, _get
from sparsernns_tpu_torch.ops.cuda.block_sparse import (BlockSparseWeight,
                                                        block_sparse_matmul,
                                                        pack_block_sparse)
from sparsernns_tpu_torch.ops.cuda.engine_layer import (Dense, LayerMode,
                                                        attach_fragments,
                                                        dense_plain,
                                                        engine_layer,
                                                        int_dot_spec, pad128,
                                                        qdq)
from sparsernns_tpu_torch.ops.cuda.engine_network import (MAX_LAYERS,
                                                          engine_network)
from sparsernns_tpu_torch.ops.cuda.fused_s5 import fused_s5_engine
from sparsernns_tpu_torch.ops.intdot import fits_planewise, weight_colsum
from sparsernns_tpu_torch.ops.scan import (Pair, blocked_diag_scan,
                                           diag_ssm_scan)
from sparsernns_tpu_torch.ops.topk import relu_top_k_sparsity, top_k_sparsity
from sparsernns_tpu_torch.quantize.config import QuantizationConfig
from sparsernns_tpu_torch.utils.trace import span

#: the engine's time block when ``block_t`` is None
DEFAULT_BLOCK_T = 512


def pow2_quantize(w: np.ndarray, bits: Optional[int]
                  ) -> Tuple[np.ndarray, Optional[float]]:
    """Symmetric pow2-scale integer quantization of a weight tensor:
    -> (int8/int16 data, scale). Pure numpy, the value rule of
    ``static.calculate_qparams(pow2scale=True)`` + ``quant_dequant``, so
    ``data * scale`` equals the static-quant emulation's dequantized
    weights. Returns (float32, None) when bits is None or >= 32."""
    if bits is None or bits >= 32:
        return np.asarray(w, np.float32), None
    w = np.asarray(w)
    absmax = float(np.abs(w).max())
    qmax = 2.0 ** (bits - 1) - 1.0
    s = max(absmax / qmax, 1e-6)
    s = 2.0 ** round(np.log2(s))
    q = np.clip(np.round(w / s), -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
    dt = np.int8 if bits <= 8 else np.int16
    return q.astype(dt), float(s)


def _pow2_quant_values(w: np.ndarray, bits: Optional[int]) -> np.ndarray:
    """Dequantized float values on the pow2 int grid (for Λ̄ and D, which
    stay in float storage)."""
    q, s = pow2_quantize(w, bits)
    if s is None:
        return q
    return q.astype(np.float32) * s


@dataclasses.dataclass
class QWeight:
    """Integer-stored weight + static per-tensor pow2 scale (None: the
    data is float), the int32 column sums of int8 data (the two-plane
    integer dot's correction row), and the tensor cores' fragments of int8
    data under a float dot (``engine_layer.attach_fragments``)."""

    data: torch.Tensor
    scale: Optional[float] = None
    colsum: Optional[torch.Tensor] = None
    frags: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return self.data.shape

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        if self.scale is None:
            return self.data.to(dtype)
        return self.data.to(dtype) * self.scale


@dataclasses.dataclass
class _LayerPack:
    """Per-layer packed operands and static grids."""

    lam: Pair                 # (P,) f32 values on the a-precision grid
    w_b: torch.Tensor         # (H, 2P) int8 [B̄_re^T | B̄_im^T], or f32
    w_c: torch.Tensor         # (2P, H) int8 [C_re^T ; -C_im^T]
    d: torch.Tensor           # (H,) f32 values on the d-precision grid
    norm_w: torch.Tensor      # (H,) BN scale / sqrt(var + eps)
    norm_b: torch.Tensor
    out2_kernel: Optional[QWeight] = None   # GLU gate dense
    out2_bias: Optional[torch.Tensor] = None
    out1_kernel: Optional[QWeight] = None   # "full" GLU value dense
    out1_bias: Optional[torch.Tensor] = None
    #: (scale, bits) of the calibrated residual requant at the layer output
    residual_requant: Optional[Tuple[float, int]] = None
    #: (s_re, s_im, bits) of the blockwise state requant
    state_requant: Optional[Tuple[float, float, int]] = None
    #: per-half pow2 scales of the int B/C packs; None for float weights
    wb_scales: Optional[Tuple[float, float]] = None
    wc_scales: Optional[Tuple[float, float]] = None   # incl. conj-sym 2x
    #: (scale, bits) frozen input grids of the GLU denses' integer dots
    #: (one plane at 8 bits or fewer, two at 9..16); None: float dots
    out2_in_scale: Optional[Tuple[float, int]] = None
    out1_in_scale: Optional[Tuple[float, int]] = None
    #: mxu16: (scale, bits) quant_ut grid of the integer B-projection, and
    #: the integer C-projection on the state codes (grid state_requant's)
    mixer_in16: Optional[Tuple[float, int]] = None
    state16: bool = False
    #: mxu16's requants of the static-quant model: quant_but (s_re, s_im,
    #: bits), quant_yt and the GLU denses' quant_output (scale, bits)
    but_requant: Optional[Tuple[float, float, int]] = None
    yt_requant: Optional[Tuple[float, int]] = None
    out2_out_requant: Optional[Tuple[float, int]] = None
    out1_out_requant: Optional[Tuple[float, int]] = None
    #: int32 column sums of int8 W_b (2P,) and of W_c's halves (H,)
    cs_wb: Optional[torch.Tensor] = None
    cs_wc_re: Optional[torch.Tensor] = None
    cs_wc_im: Optional[torch.Tensor] = None
    #: the tensor cores' fragments of int8 W_b and W_c
    #: (``engine_layer.attach_fragments``); None: fmaf chains
    wb_frags: Optional[torch.Tensor] = None
    wc_frags: Optional[torch.Tensor] = None

    @property
    def p(self) -> int:
        return self.w_b.shape[-1] // 2

    def _half_scales(self, scales: Tuple[float, float]) -> torch.Tensor:
        p = self.p
        dev = self.w_b.device
        return torch.cat([torch.full((p,), scales[0], device=dev),
                          torch.full((p,), scales[1], device=dev)])

    def wb_f32(self) -> torch.Tensor:
        """Dequantized (H, 2P) float B projection, for the scan route of
        the per-op path (the mixer kernel scales inside instead)."""
        if self.wb_scales is None:
            return self.w_b.to(torch.float32)
        return self.w_b.to(torch.float32) * self._half_scales(
            self.wb_scales)

    def wc_f32(self) -> torch.Tensor:
        if self.wc_scales is None:
            return self.w_c.to(torch.float32)
        return self.w_c.to(torch.float32) * self._half_scales(
            self.wc_scales)[:, None]


def quantized_dense(x: torch.Tensor, w, bias: torch.Tensor,
                    in_spec: Optional[Tuple[float, int]] = None,
                    out_spec: Optional[Tuple[float, int]] = None
                    ) -> torch.Tensor:
    """Dense layer on a quantized weight. ``in_spec`` (scale, bits) and
    an int8 weight with a scale: x is quantized onto that frozen grid and
    the dot runs exactly on its codes (``ops/intdot.int16_dot``: one plane
    at 8 bits or fewer, two at 9..16, the formula from x's own width);
    else dequantize and float dot (a :class:`BlockSparseWeight`: the
    block-sparse matmul over its kept tiles, which takes no input grid).
    Then the optional ``out_spec`` requant."""
    if isinstance(w, BlockSparseWeight):
        return qdq(block_sparse_matmul(x, w) + bias, out_spec)
    return dense_plain(x.to(torch.float32), Dense(w, bias, in_spec,
                                                  out_spec))


def state_activation(cfg: FxpModelConfig, xs: Pair) -> Pair:
    """Activation of the SSM state pair before the C projection, as the
    model applies it: relu top-k of ``int(topk * P)`` per half with top-k
    and ``approx_topk``, relu when relufied, else none."""
    if not cfg.relufication:
        return xs
    if cfg.topk < 1.0 and cfg.approx_topk:
        k = int(cfg.topk * xs[0].shape[-1])
        return relu_top_k_sparsity(xs[0], k), relu_top_k_sparsity(xs[1], k)
    return torch.relu(xs[0]), torch.relu(xs[1])


def engine_layer_forward(cfg: FxpModelConfig, layer: "_LayerPack",
                         h: torch.Tensor, mixer_fn,
                         act_dtype=torch.float32):
    """The per-op serving layer: norm -> mixer -> activation -> GLU (the
    denses' integer dots where the layer has input grids) -> residual
    (-> postnorm) -> relu -> top-k -> residual requant.
    ``mixer_fn(z)`` is the S5 mixer on the norm's output cast to
    ``act_dtype``: (y, the new carry or None). Returns (h, that carry)."""
    use_topk = cfg.topk < 1.0
    k = int(cfg.topk * h.shape[-1])
    skip = h
    z = h * layer.norm_w + layer.norm_b if cfg.prenorm else h
    y, carry = mixer_fn(z.to(act_dtype))
    if cfg.relufication:
        x1 = relu_top_k_sparsity(y, k) if use_topk else torch.relu(y)
    else:
        x1 = F.gelu(y, approximate="tanh")
    if cfg.glu_variant in ("half1", "half2", "full"):
        gate = torch.sigmoid(quantized_dense(x1, layer.out2_kernel,
                                             layer.out2_bias,
                                             layer.out2_in_scale))
        if cfg.glu_variant == "half1":
            base = x1
        elif cfg.glu_variant == "half2":
            base = y
        else:
            base = quantized_dense(x1, layer.out1_kernel, layer.out1_bias,
                                   layer.out1_in_scale)
        h = base * gate
    else:
        h = x1
    h = h + skip
    if not cfg.prenorm:
        h = h * layer.norm_w + layer.norm_b
    if cfg.relufication:
        h = torch.relu(h)
    if use_topk:
        h = top_k_sparsity(h, k)
    h = qdq(h, layer.residual_requant)
    return h, carry


def engine_encode(cfg: FxpModelConfig, encoder_kernel: QWeight,
                  encoder_bias: torch.Tensor, x: torch.Tensor,
                  in_scale=None, out_spec=None) -> torch.Tensor:
    """The encoder dense and its activation: relu top-k with top-k, relu
    when relufied."""
    h = quantized_dense(x, encoder_kernel, encoder_bias, in_scale, out_spec)
    if cfg.topk < 1.0:
        return relu_top_k_sparsity(h, int(cfg.topk * h.shape[-1]))
    return torch.relu(h) if cfg.relufication else h


class W8A16Engine:
    """Quantized NDNS inference engine over frozen conversion artifacts."""

    def __init__(self, params: Dict[str, Any], batch_stats: Dict[str, Any],
                 q_config: QuantizationConfig, model_cfg: FxpModelConfig,
                 act_dtype=torch.bfloat16, block_t: Optional[int] = None,
                 compact_state: bool = True,
                 block_sparse_dense: Optional[Tuple[int, int]] = (32, 128),
                 block_sparse_min_saving: float = 0.2,
                 mxu16: bool = False, route: str = "auto",
                 row_pair: bool = False, device="cuda"):
        if route not in ("auto", "xla"):
            raise ValueError(f"unknown engine route {route!r}")
        if route == "xla":
            block_sparse_dense = None  # the block-sparse matmul is a kernel
        if act_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"act_dtype {act_dtype}")
        #: the JAX package's paired-row schedule of the network kernel
        #: gives the same bits as its unpaired one; here every batch row
        #: is a thread block of its own, so the flag changes nothing
        self.row_pair = row_pair
        self.route = route
        self.cfg = cfg = model_cfg
        self.act_dtype = act_dtype
        self.device = torch.device(device)
        #: frames per time block: where the scan states are requantized
        self.block_t = DEFAULT_BLOCK_T if block_t is None else int(block_t)
        #: per-layer (p_original, p_kept) after structured-channel
        #: compaction
        self.state_channels: List[Tuple[int, int]] = []
        #: dense kernels packed block-sparse: name -> (kept tiles, tiles)
        self.dense_blocks: Dict[str, Tuple[int, int]] = {}

        if cfg.glu_variant not in ("half1", "half2", "full", "none"):
            raise ValueError(f"glu_variant {cfg.glu_variant!r}")
        if cfg.n_layers < 1:
            raise ValueError("the engine needs at least one layer")

        enc = params["encoder"]
        enc_stats = (batch_stats or {}).get("encoder", {})
        wq = q_config.non_ssm_precision
        a_bits = q_config.non_ssm_act_precision
        # 8-bit activations: the denses run integer dots on the codes of
        # their frozen quant_input grids; with mxu16, 9..16-bit ones too
        # (two planes), where the padded reduction dim fits the budget
        a8 = (a_bits is not None and a_bits <= 8
              and wq is not None and wq <= 8)
        dense16 = (mxu16 and a_bits is not None and 8 < a_bits <= 16
                   and wq is not None and wq <= 8)

        def in_scale(k_dim: int, *path):
            """(scale, bits) input grid of a dense of reduction dim k_dim."""
            if not (a8 or dense16):
                return None
            if a_bits > 8 and not fits_planewise(pad128(k_dim)):
                return None
            s = _get(params, *path, "quant_input", "scale")
            return None if s is None else (float(np.asarray(s)), int(a_bits))

        def out_requant(*path):
            """(scale, bits) quant_output grid of a dense: mxu16 only."""
            if not mxu16 or not a_bits:
                return None
            s = _get(params, *path, "quant_output", "scale")
            return None if s is None else (float(np.asarray(s)), int(a_bits))

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.array(a, order="C")).to(self.device)

        def pack_dense(name: str, w: np.ndarray, bits):
            """A QWeight, or a BlockSparseWeight of the same integer grid
            when at least ``block_sparse_min_saving`` of its
            ``block_sparse_dense`` tiles are all zero."""
            q, s = pow2_quantize(w, bits)
            if block_sparse_dense is not None:
                bsw = pack_block_sparse(q, *block_sparse_dense, scale=s,
                                        device=self.device)
                if 1.0 - bsw.density >= block_sparse_min_saving:
                    kt = -(-bsw.shape[0] // bsw.bk)
                    nt = -(-bsw.shape[1] // bsw.bn)
                    self.dense_blocks[name] = (bsw.nnz, kt * nt)
                    return bsw
            data = dev(q)
            return QWeight(data, s, weight_colsum(data)
                           if data.dtype == torch.int8 else None)

        d_input = int(np.asarray(enc["encoder"]["kernel"]).shape[0])
        #: (scale, bits) input grids of the encoder's and decoder's integer
        #: dots, and mxu16's output requants (None: float dot / none)
        self.encoder_in_scale = in_scale(d_input, "encoder", "encoder")
        self.decoder_in_scale = in_scale(cfg.d_model, "decoder")
        self.encoder_out_requant = out_requant("encoder", "encoder")
        self.decoder_out_requant = out_requant("decoder")

        self.encoder_kernel = pack_dense(
            "encoder", np.asarray(enc["encoder"]["kernel"]), wq)
        self.encoder_bias = dev(np.asarray(enc["encoder"]["bias"],
                                           np.float32))
        self.decoder_kernel = pack_dense(
            "decoder", np.asarray(params["decoder"]["kernel"]), wq)
        self.decoder_bias = dev(np.asarray(params["decoder"]["bias"],
                                           np.float32))

        self.layers: List[_LayerPack] = []
        for i in range(cfg.n_layers):
            lp = enc[f"layers_{i}"]
            ls = enc_stats.get(f"layers_{i}", {})
            lam_bar, b_bar, c_tilde, d = _discretize(lp["mixer"], cfg)

            # Structured-sparsity compaction: a state channel whose B̄ row
            # AND C column are exactly zero contributes nothing — drop it,
            # shrinking the scan width and both projections.
            p_orig = b_bar[0].shape[0]
            p_kept = p_orig
            if compact_state and c_tilde[0].shape[1] == p_orig:
                b_zero = ((np.abs(b_bar[0]).max(axis=1) == 0)
                          & (np.abs(b_bar[1]).max(axis=1) == 0))
                c_zero = ((np.abs(c_tilde[0]).max(axis=0) == 0)
                          & (np.abs(c_tilde[1]).max(axis=0) == 0))
                keep = ~(b_zero & c_zero)
                p_kept = int(keep.sum())
                if p_kept == 0:
                    keep[0] = True  # degenerate: keep one channel
                    p_kept = 1
                if p_kept < p_orig:
                    b_bar = (b_bar[0][keep], b_bar[1][keep])
                    c_tilde = (c_tilde[0][:, keep], c_tilde[1][:, keep])
                    lam_bar = (lam_bar[0][keep], lam_bar[1][keep])
            self.state_channels.append((p_orig, p_kept))

            # int storage, separate per-half pow2 scales (the static-quant
            # FakeQuantComplex quantizes re/im on their own grids). C_im is
            # negated BEFORE quantization so the packed ints carry the
            # [C_re^T; -C_im^T] sign without an int8 negate (-128 would
            # overflow).
            b_re_q, s_bre = pow2_quantize(b_bar[0], q_config.b_precision)
            b_im_q, s_bim = pow2_quantize(b_bar[1], q_config.b_precision)
            c_re_q, s_cre = pow2_quantize(c_tilde[0], q_config.c_precision)
            c_imn_q, s_cim = pow2_quantize(-c_tilde[1], q_config.c_precision)
            lam_bar = (_pow2_quant_values(lam_bar[0], q_config.a_precision),
                       _pow2_quant_values(lam_bar[1], q_config.a_precision))
            d_q = _pow2_quant_values(d, q_config.d_precision)

            # the norm as an affine prologue (BatchNorm eps 1e-5)
            mean = np.asarray(_get(ls, "norm", "mean",
                                   default=np.zeros(cfg.d_model)))
            var = np.asarray(_get(ls, "norm", "var",
                                  default=np.ones(cfg.d_model)))
            scale = np.asarray(_get(lp, "norm", "scale",
                                    default=np.ones(cfg.d_model)))
            bias = np.asarray(_get(lp, "norm", "bias",
                                   default=np.zeros(cfg.d_model)))
            nw = scale / np.sqrt(var + 1e-5)
            nb = bias - mean * nw

            w_b = np.concatenate([b_re_q.T, b_im_q.T], axis=-1)
            sgn = 2.0 if cfg.conj_sym else 1.0
            w_c = np.concatenate([c_re_q.T, c_imn_q.T], axis=0)
            wb_scales = (None if s_bre is None
                         else (float(s_bre), float(s_bim)))
            # conj-sym 2x folds into the static scales, not the ints
            wc_scales = (None if s_cre is None
                         else (sgn * float(s_cre), sgn * float(s_cim)))
            if s_cre is None:
                w_c = sgn * w_c

            # frozen state scales: blockwise state requant in the kernels
            requant = None
            s_re = _get(lp, "mixer", "quant_xt", "quant_real", "scale")
            s_im = _get(lp, "mixer", "quant_xt", "quant_imag", "scale")
            if s_re is not None and s_im is not None \
                    and q_config.ssm_act_precision:
                requant = (float(np.asarray(s_re)), float(np.asarray(s_im)),
                           int(q_config.ssm_act_precision))

            res_requant = None
            s_res = _get(lp, "quant_residual", "scale")
            if s_res is not None and q_config.non_ssm_act_precision:
                res_requant = (float(np.asarray(s_res)),
                               int(q_config.non_ssm_act_precision))

            # mxu16: the B/C projections as integer dots on the codes of
            # the static path's quant_ut / quant_xt grids; they need int8
            # weight packs (the two-plane budget assumes int8 weights)
            ssm_bits = q_config.ssm_act_precision
            b_i8 = (q_config.b_precision is not None
                    and q_config.b_precision <= 8)
            c_i8 = (q_config.c_precision is not None
                    and q_config.c_precision <= 8)
            mixer16 = None
            if (mxu16 and ssm_bits and ssm_bits <= 16
                    and wb_scales is not None and b_i8
                    and (ssm_bits <= 8
                         or fits_planewise(pad128(cfg.d_model)))):
                s_ut = _get(lp, "mixer", "quant_ut", "scale")
                if s_ut is not None:
                    mixer16 = (float(np.asarray(s_ut)), int(ssm_bits))
            st16 = bool(mxu16 and requant is not None
                        and wc_scales is not None and c_i8
                        and (requant[2] <= 8
                             or fits_planewise(pad128(p_kept))))
            but_rq = yt_rq = None
            if mxu16 and ssm_bits:
                s_br = _get(lp, "mixer", "quant_but", "quant_real", "scale")
                s_bi = _get(lp, "mixer", "quant_but", "quant_imag", "scale")
                if s_br is not None and s_bi is not None:
                    but_rq = (float(np.asarray(s_br)),
                              float(np.asarray(s_bi)), int(ssm_bits))
                s_yt = _get(lp, "mixer", "quant_yt", "scale")
                if s_yt is not None:
                    yt_rq = (float(np.asarray(s_yt)), int(ssm_bits))

            out2_k = out2_b = out1_k = out1_b = None
            out2_s = out1_s = out2_o = out1_o = None
            if cfg.glu_variant in ("full", "half1", "half2"):
                out2_k = pack_dense(f"layers_{i}/out2",
                                    np.asarray(lp["out2"]["kernel"]), wq)
                out2_b = dev(np.asarray(lp["out2"]["bias"], np.float32))
                out2_s = in_scale(cfg.d_model, "encoder", f"layers_{i}",
                                  "out2")
                out2_o = out_requant("encoder", f"layers_{i}", "out2")
            if cfg.glu_variant == "full":
                out1_k = pack_dense(f"layers_{i}/out1",
                                    np.asarray(lp["out1"]["kernel"]), wq)
                out1_b = dev(np.asarray(lp["out1"]["bias"], np.float32))
                out1_s = in_scale(cfg.d_model, "encoder", f"layers_{i}",
                                  "out1")
                out1_o = out_requant("encoder", f"layers_{i}", "out1")

            w_b, w_c = dev(w_b), dev(w_c)
            p = w_b.shape[-1] // 2
            cs = ((None, None, None) if w_b.dtype != torch.int8 else
                  (weight_colsum(w_b), weight_colsum(w_c[:p]),
                   weight_colsum(w_c[p:])))
            self.layers.append(_LayerPack(
                lam=(dev(lam_bar[0]), dev(lam_bar[1])),
                w_b=w_b, w_c=w_c, d=dev(d_q),
                norm_w=dev(nw.astype(np.float32)),
                norm_b=dev(nb.astype(np.float32)),
                out2_kernel=out2_k, out2_bias=out2_b,
                out1_kernel=out1_k, out1_bias=out1_b,
                state_requant=requant,
                wb_scales=wb_scales, wc_scales=wc_scales,
                residual_requant=res_requant,
                out2_in_scale=out2_s, out1_in_scale=out1_s,
                mixer_in16=mixer16, state16=st16,
                but_requant=but_rq, yt_requant=yt_rq,
                out2_out_requant=out2_o, out1_out_requant=out1_o,
                cs_wb=cs[0], cs_wc_re=cs[1], cs_wc_im=cs[2]))
        self._demote_int_sites(mxu16)
        if route == "xla":
            self._demote_xla()

        self.mode = LayerMode(prenorm=cfg.prenorm,
                              relufication=cfg.relufication,
                              glu=cfg.glu_variant,
                              relu_state=cfg.relufication,
                              act_dtype=act_dtype)
        #: whole-layer route (K5): one kernel per layer over the stored
        #: residual stream, for the offline call and every streaming
        #: chunk; else the per-op route. Tests force the per-op route by
        #: clearing this flag alone, as the JAX package's tests do.
        self._stack_ok = route != "xla" and self._fused_stack_eligible()
        if mxu16 and not self._stack_ok:
            self._demote_mxu16()
            self._stack_ok = (route != "xla"
                              and self._fused_stack_eligible())
        #: which dot sites run integer dots, and whether any of mxu16's
        #: requants applies (the JAX engine's introspection)
        self.mxu16 = dict(
            requested=mxu16,
            mixer=self.layers[0].mixer_in16 is not None,
            state=bool(self.layers[0].state16),
            dense=self.encoder_in_scale is not None
            or self.decoder_in_scale is not None,
            requants=bool(
                any(lp.yt_requant is not None
                    or lp.but_requant is not None
                    or lp.out2_out_requant is not None
                    or lp.out1_out_requant is not None
                    for lp in self.layers)
                or self.encoder_out_requant is not None
                or self.decoder_out_requant is not None))
        #: whole-network route (K6): one kernel for the offline call when
        #: the whole-layer route applies and the layer limit allows
        self._network_ok = (route != "xla"
                            and self._fused_network_eligible())
        #: whether the kernels run the int8 float dots on the tensor cores
        #: (every route that launches them reads the same fragments)
        self.tensor_cores = attach_fragments(self._enc, self.layers,
                                             self._dec, self.mode)

    def _demote_xla(self) -> None:
        """``route="xla"`` runs no integer dot anywhere: every dense falls
        back to its dequantized float weight, and mxu16's sites and
        requants go; the state and residual requants stay."""
        for lp in self.layers:
            lp.out2_in_scale = lp.out1_in_scale = None
            lp.mixer_in16 = None
            lp.state16 = False
            lp.but_requant = lp.yt_requant = None
            lp.out2_out_requant = lp.out1_out_requant = None
        self.encoder_in_scale = self.decoder_in_scale = None
        self.encoder_out_requant = self.decoder_out_requant = None

    def _demote_int_sites(self, mxu16: bool) -> None:
        """The JAX engine's all-or-none rule: its network kernel shares one
        operand list across layers, so an integer mixer, state or
        two-plane GLU site runs in every layer or in none. The port's
        kernels take per-layer structs, but apply the same demotions, so
        the same frozen tree serves the same numbers."""
        layers = self.layers
        if any(lp.mixer_in16 is None for lp in layers):
            for lp in layers:
                lp.mixer_in16 = None
        if not all(lp.state16 for lp in layers):
            for lp in layers:
                lp.state16 = False

        def cs16(spec):
            return spec is not None and spec[1] > 8

        for name in ("out2_in_scale", "out1_in_scale"):
            if len({cs16(getattr(lp, name)) for lp in layers}) > 1:
                for lp in layers:
                    if cs16(getattr(lp, name)):
                        setattr(lp, name, None)

    def _demote_mxu16(self) -> None:
        """mxu16 lives on the whole-layer routes (the per-op mixer kernel
        has no quant_ut / quant_but / quant_yt hooks): off them the engine
        drops every mxu16 site, as JAX does, and keeps the 8-bit input
        grids, which the per-op route serves alike."""
        for lp in self.layers:
            lp.mixer_in16 = None
            lp.state16 = False
            lp.but_requant = lp.yt_requant = None
            lp.out2_out_requant = lp.out1_out_requant = None
            if lp.out2_in_scale is not None and lp.out2_in_scale[1] > 8:
                lp.out2_in_scale = None
            if lp.out1_in_scale is not None and lp.out1_in_scale[1] > 8:
                lp.out1_in_scale = None
        self.encoder_out_requant = self.decoder_out_requant = None
        for name in ("encoder_in_scale", "decoder_in_scale"):
            spec = getattr(self, name)
            if spec is not None and spec[1] > 8:
                setattr(self, name, None)

    @staticmethod
    def _int8_dense_ok(w, in_scale) -> bool:
        """A kernel's integer dot needs int8 QWeight storage with a scale
        beside its frozen input grid."""
        return (isinstance(w, QWeight)
                and int_dot_spec(w, in_scale) is not None)

    def _fused_stack_eligible(self) -> bool:
        """By configuration: the whole-layer kernels express neither
        model-dim top-k, nor a block-sparse GLU dense, nor a GLU input
        grid without an int8 weight, nor a residual requant wider than 16
        bits (int16 stream codes); such an engine runs the per-op route,
        with the same numerics up to f32 summation order. (The JAX
        package's VMEM budget has no counterpart here.)"""
        if self.cfg.topk < 1.0:
            return False
        for lp in self.layers:
            for k, s in ((lp.out2_kernel, lp.out2_in_scale),
                         (lp.out1_kernel, lp.out1_in_scale)):
                if isinstance(k, BlockSparseWeight):
                    return False
                if s is not None and not self._int8_dense_ok(k, s):
                    return False
        return all(lp.residual_requant is None or lp.residual_requant[1] <= 16
                   for lp in self.layers)

    def _fused_network_eligible(self) -> bool:
        """By configuration only: the network kernel needs the whole-layer
        route and dense (not block-sparse) encoder and decoder, and takes
        up to ``MAX_LAYERS`` layers in one launch; deeper models keep the
        per-layer stack."""
        if not self._stack_ok or self._bs_encoder or self._bs_decoder:
            return False
        for w, s in ((self.encoder_kernel, self.encoder_in_scale),
                     (self.decoder_kernel, self.decoder_in_scale)):
            if s is not None and not self._int8_dense_ok(w, s):
                return False
        return 1 <= len(self.layers) <= MAX_LAYERS

    @property
    def _bs_encoder(self) -> bool:
        return isinstance(self.encoder_kernel, BlockSparseWeight)

    @property
    def _bs_decoder(self) -> bool:
        return isinstance(self.decoder_kernel, BlockSparseWeight)

    def _encode_outside(self, x: torch.Tensor) -> torch.Tensor:
        """A block-sparse encoder ahead of the first layer launch (K7):
        its output (with mxu16's output requant) as the stream that launch
        reads, in ``act_dtype``."""
        return engine_encode(self.cfg, self.encoder_kernel,
                             self.encoder_bias, x, self.encoder_in_scale,
                             self.encoder_out_requant).to(self.act_dtype)

    def _decode_outside(self, r: torch.Tensor,
                        in_rq: Optional[Tuple[float, int]]) -> torch.Tensor:
        """A block-sparse decoder after the last layer launch (K7), on its
        stored stream: codes times the last residual requant's scale (or
        the ``act_dtype`` values), float32 out."""
        rf = r.to(torch.float32)
        if in_rq is not None:
            rf = rf * in_rq[0]
        return quantized_dense(rf, *self._dec)

    @property
    def _enc(self) -> Dense:
        """The encoder as the kernels take it, with its grids."""
        return Dense(self.encoder_kernel, self.encoder_bias,
                     self.encoder_in_scale, self.encoder_out_requant)

    @property
    def _dec(self) -> Dense:
        return Dense(self.decoder_kernel, self.decoder_bias,
                     self.decoder_in_scale, self.decoder_out_requant)

    def _apply_stack(self, x: torch.Tensor, block_t: int,
                     out_dtype=torch.float32) -> torch.Tensor:
        """Whole-layer-kernel forward: N launches over the stored residual
        stream; the first also runs the encoder, the last the decoder,
        unless it is block-sparse: then it runs outside, through K7. The
        JAX stack pads L up to its block ``min(block_t, ceil8(L))`` with
        zero rows; the block is kept, the padding is not."""
        t = min(block_t, -(-x.shape[1] // 8) * 8)
        r, in_rq = x, None
        enc = self._enc
        if self._bs_encoder:
            r, enc = self._encode_outside(x), None
        dec = None if self._bs_decoder else self._dec
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            r = engine_layer(
                r, layer, self.mode, block_t=t, in_requant=in_rq,
                enc=enc if i == 0 else None,
                dec=dec if i == last else None, out_dtype=out_dtype)
            in_rq = layer.residual_requant
        if self._bs_decoder:
            return self._decode_outside(r, in_rq).to(out_dtype)
        return r

    def _apply_network(self, x: torch.Tensor, block_t: int,
                       out_dtype=torch.float32) -> torch.Tensor:
        """Whole-network-kernel forward: one launch. The JAX kernel's
        block is ``min(block_t, L)``, cut to a multiple of 8 when it is
        shorter than L, and the last ``L % t`` frames are one short block."""
        l = x.shape[1]
        t = min(block_t, l)
        if t < l:
            t = max(t - t % 8, 8)
        return engine_network(x, self._enc, self.layers, self._dec,
                              self.mode, block_t=t, out_dtype=out_dtype)

    @staticmethod
    def _io_dtype(x: torch.Tensor) -> torch.dtype:
        """The mask comes back in the dtype the magnitudes arrived in:
        bf16 in -> bf16 out, everything else f32."""
        return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32

    def _input(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device)
        return x if x.dtype == torch.bfloat16 else x.to(torch.float32)

    def _state_topk(self) -> bool:
        cfg = self.cfg
        return cfg.relufication and cfg.topk < 1.0 and cfg.approx_topk

    def _mixer(self, layer: _LayerPack, block_t: int,
               carry: Optional[Pair] = None):
        """The S5 mixer of one layer on the per-op route, as a function of
        its input returning (y, the new carry or None): one kernel (K4a's
        engine modes, or K4b with a carry); or with top-k on the states,
        which that kernel cannot apply, the B-projection and the
        C-projection as ``torch.matmul`` of the dequantized weights around
        the scan kernel with its block requant, the state activation
        between (offline only). On ``route="xla"`` the scan is the blocked
        matmul scan, from the carry where there is one, with the new carry
        its final state (on the requant grid where the state requant
        applies)."""
        if self.route == "xla":
            def blocked_mixer(z: torch.Tensor):
                z = z.to(torch.float32)
                bu = z @ layer.wb_f32()
                p = layer.p
                xs = blocked_diag_scan(
                    layer.lam, (bu[..., :p], bu[..., p:]),
                    block_t=block_t, carry_init=carry,
                    block_requant=layer.state_requant)
                new_c = (None if carry is None
                         else (xs[0][..., -1, :], xs[1][..., -1, :]))
                xs = state_activation(self.cfg, xs)
                return (torch.cat(xs, dim=-1) @ layer.wc_f32()
                        + layer.d * z, new_c)

            return blocked_mixer
        if not self._state_topk():
            def kernel_mixer(z: torch.Tensor):
                out = fused_s5_engine(
                    z, layer.lam, layer.w_b, layer.w_c, layer.d,
                    block_t=block_t, wb_scales=layer.wb_scales,
                    wc_scales=layer.wc_scales,
                    block_requant=layer.state_requant,
                    relu_state=self.cfg.relufication, carry=carry,
                    frags=(layer.wb_frags, layer.wc_frags))
                return (out, None) if carry is None else out

            return kernel_mixer

        def scan_mixer(z: torch.Tensor):
            z = z.to(torch.float32)
            bu = z @ layer.wb_f32()
            p = layer.p
            xs = diag_ssm_scan(layer.lam, (bu[..., :p], bu[..., p:]),
                               block_requant=layer.state_requant,
                               block_t=block_t)
            xs = state_activation(self.cfg, xs)
            return torch.cat(xs, dim=-1) @ layer.wc_f32() + layer.d * z, None

        return scan_mixer

    @torch.no_grad()
    def _apply_per_op(self, x: torch.Tensor, block_t: int,
                      carries: Optional[Sequence[Pair]] = None):
        """Per-op forward: encoder, then each layer around its mixer
        (:meth:`_mixer`), then the decoder. The mixer input is cast to
        ``act_dtype``; the residual stream stays float32 on the frozen
        requant grids. With ``carries`` (a streaming chunk) each layer's
        mixer kernel starts from its carry and returns the new one (K4b),
        and the chunk length must be a multiple of the time block
        ``min(block_t, L_chunk)``: returns (mask chunk, new carries)."""
        cfg = self.cfg
        if carries is not None:
            block_t = min(block_t, x.shape[1])
        h = engine_encode(cfg, self.encoder_kernel, self.encoder_bias,
                          x.to(torch.float32), self.encoder_in_scale)
        new_carries = []
        for i, layer in enumerate(self.layers):
            carry = None if carries is None else carries[i]
            h, new_c = engine_layer_forward(
                cfg, layer, h, self._mixer(layer, block_t, carry),
                act_dtype=self.act_dtype)
            new_carries.append(new_c)
        out = quantized_dense(h, self.decoder_kernel, self.decoder_bias,
                              self.decoder_in_scale)
        if carries is None:
            return out.to(self._io_dtype(x))
        return out, tuple(new_carries)

    @torch.no_grad()
    def _apply(self, x: torch.Tensor, block_t: int) -> torch.Tensor:
        """x: (B, L, d_input) f32 or bf16 -> mask (B, L, d_output)."""
        if self._network_ok and self._stack_ok:
            return self._apply_network(x, block_t, self._io_dtype(x))
        if self._stack_ok:
            return self._apply_stack(x, block_t, self._io_dtype(x))
        return self._apply_per_op(x, block_t)

    def __call__(self, x) -> torch.Tensor:
        with span("engine.call"):
            return self._apply(self._input(x), self.block_t)

    # ---------------- streaming (chunked) serving ----------------

    def init_stream_state(self, batch: int) -> Tuple[Pair, ...]:
        """Zero carries for a new stream: per-layer (B, P) state pairs."""
        return tuple(
            (torch.zeros((batch, layer.p), device=self.device),
             torch.zeros((batch, layer.p), device=self.device))
            for layer in self.layers)

    @torch.no_grad()
    def _apply_chunk_stack(self, x: torch.Tensor, carries: Sequence[Pair],
                           block_t: int, lo: int = 0, encode: bool = True,
                           decode: bool = True,
                           layers: Optional[Sequence[_LayerPack]] = None):
        """Chunked whole-layer-kernel forward: per-layer carry in and out;
        the mask comes back float32. The chunk length must be a multiple of
        the time block ``min(block_t, L_chunk)``. A block-sparse encoder or
        decoder runs outside the first or last launch, as in
        :meth:`_apply_stack`.

        Pipeline-stage mode: ``layers`` is the stage's slice of
        ``self.layers`` and ``lo`` the global index of its first layer.
        With ``encode=False`` x is the previous stage's stored stream (the
        codes of layer lo-1's residual requant, or ``act_dtype``); with
        ``decode=False`` the stored stream is returned for the next stage
        instead of the decoded output."""
        layers = self.layers if layers is None else layers
        t = min(block_t, x.shape[1])
        if x.shape[1] % t:
            raise ValueError(
                f"chunk length {x.shape[1]} is not divisible by the time "
                f"block {t}")
        in_rq = self.layers[lo - 1].residual_requant if lo > 0 else None
        r = x
        enc = self._enc if encode else None
        if encode and self._bs_encoder:
            r, enc = self._encode_outside(x), None
        dec = self._dec if decode and not self._bs_decoder else None
        new_carries = []
        last = len(layers) - 1
        for i, (layer, carry) in enumerate(zip(layers, carries)):
            r, new_c = engine_layer(
                r, layer, self.mode, block_t=t, in_requant=in_rq,
                carry=carry, enc=enc if i == 0 else None,
                dec=dec if i == last else None)
            new_carries.append(new_c)
            in_rq = layer.residual_requant
        if decode and self._bs_decoder:
            r = self._decode_outside(r, in_rq)
        return r, tuple(new_carries)

    def process_chunk(self, x, carries=None):
        """x: (B, L_chunk, d_input) -> (mask chunk, new carries).

        Chunked calls match one whole-sequence call when the chunk length
        equals the engine's ``block_t`` (the state-requant granularity);
        for other chunk lengths the recurrence is still exact but the
        block-boundary requantization happens at chunk granularity.
        L_chunk must be a multiple of the effective time block."""
        if self._state_topk():
            raise NotImplementedError(
                "chunked streaming with state top-k is not supported (the "
                "fused carry kernel applies plain state relu); serve topk "
                "models with whole-sequence engine calls")
        x = self._input(x)
        if carries is None:
            carries = self.init_stream_state(x.shape[0])
        if self._stack_ok:
            return self._apply_chunk_stack(x, carries, self.block_t)
        return self._apply_per_op(x, self.block_t, carries)

    @staticmethod
    def from_artifacts(checkpoint_dir: str, cfg,
                       device="cuda") -> "W8A16Engine":
        """The engine of ``cfg`` over the frozen tree that the conversion
        pipeline (``quantize/convert.convert``) stored under
        ``<checkpoint_dir>/conversion``, built as ``engine_from_frozen``
        builds it there."""
        import os
        from sparsernns_tpu_torch.quantize.convert import engine_from_frozen
        from sparsernns_tpu_torch.train.checkpoint import ArtifactStore
        store = ArtifactStore(os.path.join(checkpoint_dir, "conversion"))
        for name in ("frozen_params", "frozen_stats"):
            if not store.exists(name):
                raise FileNotFoundError(
                    f"no {name} under {store.directory}: run the "
                    "conversion pipeline with calibrate_quant first")
        return engine_from_frozen(cfg, store.load("frozen_params"),
                                  store.load("frozen_stats"), device=device)
