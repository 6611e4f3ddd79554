"""The S5 SSM mixer (counterpart of ``sparsernns_tpu/models/ssm.py``).

Inputs are (B, L, H); complex numbers are (re, im) pairs of float32
tensors. The B and C projections are each one real matmul against a
stacked (H, 2P) / (2P, H) weight. The routes through the mixer:

- the whole-layer tail kernel (``ops/cuda/layer_tail.py``) takes its
  operands from :meth:`S5SSM.layer_tail_operands` — the offline forward and
  training of a prenorm-BatchNorm layer around a unidirectional
  ``scan_mode="fused"`` mixer;
- :meth:`S5SSM.forward` (no carry) on such a mixer is the mixer kernel
  (``ops/cuda/fused_s5.py`` ``FusedS5Fn``: B-projection, scan and
  C-projection in one launch, the states never in device memory,
  differentiable) and returns no state — the offline forward and training
  of every other float layer (postnorm, LayerNorm);
- the carried call (:meth:`S5SSM.forward_stream`, streaming), a
  ``scan_mode="pallas"`` mixer, a ``bidirectional`` mixer and a mixer with
  activation top-k (``topk < 1``) run
  B-projection, the stand-alone scan kernel (``ops/scan.py``
  ``diag_ssm_scan``, differentiable without a carry) and C-projection. A
  bidirectional mixer scans both ways and projects the two state sets with
  one C of 2P columns (``C1`` and ``C2`` when C is projected from the
  eigenbasis); only the forward states pass the relu, or with top-k and
  ``approx_topk`` a relu top-k of ``int(topk * P)`` per state half. A
  bidirectional float mixer on the scan kernel without a carry, relu,
  top-k or bias (:meth:`S5SSM._buffers_route`) runs both scans inside the
  projections' buffers (``ops/scan.py`` ``BiDiagScanFn``: the states
  written into the C-projection's input, their adjoints reading its
  cotangent in place); every other one the two scans and the
  concatenations;
- a ``scan_mode="sequential"`` mixer (float or QAT) runs the same
  projections around the step-by-step scan in plain PyTorch
  (``ops/scan.py`` ``sequential_diag_scan``): the JAX package's naive
  scan, which its conversion pipeline validates the model with; a
  ``scan_mode="blocked"`` mixer (float only) around the block-parallel
  matmul scan (``blocked_diag_scan``), plain PyTorch as the JAX package
  made it, free of kernels;
- with ``bn_fusion`` (the layer's ``fuse_batchnorm_linear``) the
  preceding BatchNorm folds into B̄, D and two bias terms
  (:meth:`S5SSM.fused_operands`); the bias keeps the mixer off the mixer
  kernel, so it runs the stand-alone scans, as in the JAX package;
- under dynamic fake-quant (QAT: a ``q_config`` with precisions and no
  static quant) the same routes with fake-quantized operands, as the JAX
  package's ``_apply``: the mixer kernel's and the scan kernel's QAT modes
  (in-scan fake-quant over time blocks of ``block_t``, per-block or, with
  ``qat_global_scales``, one global state scale), or with
  ``scan_mode="associative"`` the associative scan with the QAT
  hadamards; such a mixer never gives the whole-layer kernel its
  operands;
- with ``q_config.static_quant`` :meth:`S5SSM.forward` is the
  static-quant path: every operand through its ``FakeQuant`` and a
  sequential scan that requantizes the state after each step — the model
  that calibration observes and that the serving engine is checked
  against. It top-ks no state, as in the JAX package (the serving engine
  does: the reference's emulation and engine differ at that site).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from sparsernns_tpu_torch.models.ssm_init import (init_cv, init_log_steps,
                                                  init_vinv_b, project_cv,
                                                  trunc_standard_normal)
from sparsernns_tpu_torch.ops.scan import (BiDiagScanFn, Pair,
                                           diag_ssm_scan,
                                           sequential_diag_scan)
from sparsernns_tpu_torch.ops.topk import relu_top_k_sparsity
from sparsernns_tpu_torch.quantize.config import QuantizationConfig
from sparsernns_tpu_torch.quantize.qat import (QuantizedOps, act_qat_bits,
                                               fake_quant, is_qat)
from sparsernns_tpu_torch.quantize.static import (FakeQuant,
                                                  FakeQuantComplex,
                                                  quant_dequant)
from sparsernns_tpu_torch.utils.trace import count, span


def discretize_zoh(lam: Pair, b: Pair, delta: torch.Tensor
                   ) -> Tuple[Pair, Pair]:
    """Zero-order hold. lam: (P,) pair; b: (P, H) pair; delta: (P,).
    Returns (lambda_bar (P,), b_bar (P, H)) pairs."""
    lr, li = lam
    er = torch.exp(lr * delta)
    lam_bar = (er * torch.cos(li * delta), er * torch.sin(li * delta))
    # B_bar = (1/Lambda) (Lambda_bar - 1) * B
    denom = lr * lr + li * li
    gr = (lam_bar[0] - 1.0) * lr / denom + lam_bar[1] * li / denom
    gi = lam_bar[1] * lr / denom - (lam_bar[0] - 1.0) * li / denom
    br, bi = b
    b_bar = (gr[:, None] * br - gi[:, None] * bi,
             gr[:, None] * bi + gi[:, None] * br)
    return lam_bar, b_bar


def discretize_bilinear(lam: Pair, b: Pair, delta: torch.Tensor
                        ) -> Tuple[Pair, Pair]:
    """Bilinear (Tustin) discretization."""
    lr, li = lam
    hr, hi = 1.0 - 0.5 * delta * lr, -0.5 * delta * li  # 1 - Δ/2·Λ
    denom = hr * hr + hi * hi
    blr, bli = hr / denom, -hi / denom  # BL = 1/(1 - Δ/2·Λ)
    pr, pi = 1.0 + 0.5 * delta * lr, 0.5 * delta * li  # 1 + Δ/2·Λ
    lam_bar = (blr * pr - bli * pi, blr * pi + bli * pr)
    gr, gi = blr * delta, bli * delta
    br, bi = b
    b_bar = (gr[:, None] * br - gi[:, None] * bi,
             gr[:, None] * bi + gi[:, None] * br)
    return lam_bar, b_bar


class S5SSM(nn.Module):
    """S5 state-space mixer over (B, L, H) inputs.

    Parameters keep the JAX package's names and shapes: Lambda_re /
    Lambda_im (P,), B (P, H, 2), C (H, P, 2), D (H,), log_step (P, 1);
    with ``bidirectional`` C1 and C2 (H, P, 2) each in place of C, or one
    C (H, 2P, 2) under ``c_init="complex_normal"``.

    ``scan_mode``: ``"fused"`` (the mixer kernel where it applies),
    ``"pallas"`` (always the stand-alone scan kernel; the name is the JAX
    package's), ``"associative"``, ``"sequential"`` or ``"blocked"``
    (plain PyTorch; the static-quant model runs the sequential scan), or
    ``"sp"``: the input is this rank's time chunk of the clip and the
    scan the sequence-parallel one over ``seq_group``
    (``parallel/seqscan.seq_chunk_scan``: the scan kernel on the chunk,
    then the carry of the chunks before), unidirectional and without a
    carry, as in the JAX package (whose QAT in-scan fake-quant it skips
    too).
    """

    def __init__(self, lambda_init, v, vinv, h: int, p: int,
                 c_init: str = "lecun_normal", discretization: str = "zoh",
                 dt_min: float = 0.001, dt_max: float = 0.1,
                 conj_sym: bool = True, clip_eigs: bool = False,
                 bidirectional: bool = False, step_rescale: float = 1.0,
                 relufication: bool = False,
                 generator: Optional[torch.Generator] = None,
                 q_config: Optional[QuantizationConfig] = None,
                 scan_mode: str = "fused", topk: float = 1.0,
                 approx_topk: bool = False, block_t: int = 256,
                 qat_global_scales: bool = False):
        super().__init__()
        if discretization not in ("zoh", "bilinear"):
            raise NotImplementedError(f"discretization {discretization}")
        self.h, self.p = h, p
        self.discretization = discretization
        self.conj_sym = conj_sym
        self.clip_eigs = clip_eigs
        self.step_rescale = step_rescale
        self.relufication = relufication
        self.bidirectional = bidirectional
        self.scan_mode = scan_mode
        self.topk = topk
        self.approx_topk = approx_topk
        self.block_t = block_t
        self.qat_global_scales = qat_global_scales
        #: ``scan_mode="sp"``: the process group of the mesh's seq axis,
        #: over whose ranks the time chunks of one clip lie (set by
        #: ``train/loop.build_model``)
        self.seq_group = None
        self.q_config = cfg = q_config or QuantizationConfig.none()
        self.q_ops = QuantizedOps.create(cfg)
        #: dynamic fake-quant (QAT): the float paths quantize their operands
        self.qat = is_qat(cfg)
        if cfg.static_quant and bidirectional:
            raise NotImplementedError(
                "the static-quant model has no bidirectional mixer")
        if cfg.static_quant:
            kw = dict(pow2scale=True, calibrating=cfg.calibrating)
            self.quant_a = FakeQuantComplex(bits=cfg.a_precision, **kw)
            self.quant_b = FakeQuantComplex(bits=cfg.b_precision, **kw)
            self.quant_c = FakeQuantComplex(bits=cfg.c_precision, **kw)
            self.quant_d = FakeQuant(bits=cfg.d_precision, **kw)
            self.quant_xt = FakeQuantComplex(bits=cfg.ssm_act_precision, **kw)
            self.quant_ut = FakeQuant(bits=cfg.ssm_act_precision, **kw)
            self.quant_but = FakeQuantComplex(bits=cfg.ssm_act_precision,
                                              **kw)
            self.quant_yt = FakeQuant(bits=cfg.ssm_act_precision, **kw)

        lam = np.asarray(lambda_init)
        self.Lambda_re = nn.Parameter(torch.from_numpy(
            lam.real.astype(np.float32).copy()))
        self.Lambda_im = nn.Parameter(torch.from_numpy(
            lam.imag.astype(np.float32).copy()))
        self.B = nn.Parameter(init_vinv_b(np.asarray(vinv), h, generator))
        local_p = 2 * p if conj_sym else p
        if c_init == "lecun_normal":
            draw_c = lambda: init_cv(np.asarray(v), h, generator)  # noqa: E731
        elif c_init == "trunc_standard_normal":
            draw_c = lambda: project_cv(  # noqa: E731
                trunc_standard_normal(h, local_p, generator), np.asarray(v))
        elif c_init == "complex_normal":
            draw_c = None
        else:
            raise NotImplementedError(f"C_init {c_init}")
        if draw_c is None:
            cols = 2 * p if bidirectional else p
            self.C = nn.Parameter(torch.randn(
                (h, cols, 2), generator=generator) * 0.5 ** 0.5)
        elif bidirectional:
            self.C1 = nn.Parameter(draw_c())
            self.C2 = nn.Parameter(draw_c())
        else:
            self.C = nn.Parameter(draw_c())
        self.D = nn.Parameter(torch.randn((h,), generator=generator))
        self.log_step = nn.Parameter(
            init_log_steps(p, dt_min, dt_max, generator))

    def _lambda(self) -> Pair:
        lr = self.Lambda_re
        if self.clip_eigs:
            lr = torch.clamp(lr, max=-1e-4)
        return lr, self.Lambda_im

    def discretized(self) -> Tuple[Pair, Pair]:
        """(lambda_bar (P,), b_bar (P, H)) pairs."""
        step = self.step_rescale * torch.exp(self.log_step[:, 0])
        b_pair = (self.B[..., 0], self.B[..., 1])
        if self.discretization == "zoh":
            return discretize_zoh(self._lambda(), b_pair, step)
        return discretize_bilinear(self._lambda(), b_pair, step)

    def _w_b(self, b_bar: Pair) -> torch.Tensor:
        """[B̄_re^T | B̄_im^T] (H, 2P), under QAT each half fake-quantized
        to ``b_precision``."""
        bits = self.q_config.b_precision if self.qat else None
        return torch.cat([fake_quant(b_bar[0], bits).T,
                          fake_quant(b_bar[1], bits).T], dim=-1)

    def _c_tilde(self) -> Pair:
        """C as a (re, im) pair of (H, P), or (H, 2P) when bidirectional."""
        if hasattr(self, "C1"):
            return (torch.cat([self.C1[..., 0], self.C2[..., 0]], dim=-1),
                    torch.cat([self.C1[..., 1], self.C2[..., 1]], dim=-1))
        return self.C[..., 0], self.C[..., 1]

    def _w_c(self) -> torch.Tensor:
        """[C_re^T; -C_im^T] (2P, H), under QAT each half fake-quantized to
        ``c_precision``, with the conj-sym factor 2 folded in (a power of
        two: the same products as scaling the projection after it)."""
        c_re, c_im = self._c_tilde()
        bits = self.q_config.c_precision if self.qat else None
        scale = 2.0 if self.conj_sym else 1.0
        return scale * torch.cat([fake_quant(c_re, bits).T,
                                  -fake_quant(c_im, bits).T], dim=0)

    def expresses_tail(self) -> bool:
        """Whether the whole-layer tail kernel can express this mixer: not
        bidirectional, ``scan_mode="fused"``, no static or dynamic
        quantization, no activation top-k (which the tail kernel applies at
        none of its sites)."""
        return (self.scan_mode == "fused" and not self.bidirectional
                and not self.q_config.any_quantized and self.topk >= 1.0)

    def layer_tail_operands(self):
        """Operands of the whole-layer tail kernel: (lam_bar, w_b, w_c, d,
        relu_state), or None where that kernel cannot express the mixer
        (:meth:`expresses_tail`) and the layer runs its unfused route."""
        if not self.expresses_tail():
            return None
        lam_bar, b_bar = self.discretized()
        return (lam_bar, self._w_b(b_bar), self._w_c(), self.D,
                self.relufication)

    def fused_operands(self, bn_fusion: Optional[dict]):
        """(lam_bar, b_bar, d, b_bias, d_bias): the discretized operands,
        with a preceding BatchNorm folded in when ``bn_fusion`` (mean, var,
        eps, scale, bias) is given (the JAX package's ``_fused_operands``):
        s = scale / sqrt(var + eps), t = bias - mean * s, B̄ ← B̄ · s,
        b_bias = B̄ t, D ← D · s, d_bias = D t. Without it both biases are
        None."""
        lam_bar, b_bar = self.discretized()
        if bn_fusion is None:
            return lam_bar, b_bar, self.D, None, None
        scale = bn_fusion["scale"] / torch.sqrt(bn_fusion["var"]
                                                + bn_fusion["eps"])
        bias = bn_fusion["bias"] - bn_fusion["mean"] * scale
        b_bias = (b_bar[0] @ bias, b_bar[1] @ bias)
        b_bar = (b_bar[0] * scale, b_bar[1] * scale)
        return lam_bar, b_bar, self.D * scale, b_bias, self.D * bias

    def forward(self, u: torch.Tensor, bn_fusion: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[Pair]]:
        """The offline, differentiable call. u: (B, L, H) -> (ys (B, L, H),
        states). A unidirectional ``scan_mode="fused"`` mixer without top-k
        runs the mixer kernel, which has no state to return (None, as in
        the JAX package); every other float or QAT mixer runs the
        stand-alone scans without a carry and returns the (re, im) pair of
        its states as the C-projection reads them (after the relu; both
        directions of a bidirectional mixer), as the JAX package's
        ``_apply`` does; the static-quant path returns the final state of
        its sequential scan.

        Under QAT (dynamic fake-quant) the mixer kernel gets the
        fake-quantized W_b and W_c halves and, when an activation precision
        of the SSM is below 32 bits, the fake-quantized u and D, and runs
        its QAT mode with ``qat_bits`` (a_bits, act_bits) over time blocks
        of ``block_t``; with ``qat_global_scales`` one state absmax, from
        an unquantized B-projection and float scan under no_grad, scales
        every in-scan fake-quant.

        ``bn_fusion``: the preceding BatchNorm to fold in
        (:meth:`fused_operands`); such a call runs the stand-alone scans."""
        if self.q_config.static_quant:
            return self._apply_static_quant(u)
        cfg = self.q_config
        lam_bar, b_bar, d, b_bias, d_bias = self.fused_operands(bn_fusion)
        w_b = self._w_b(b_bar)
        if (self.scan_mode == "fused" and not self.bidirectional
                and not self.topk < 1.0 and b_bias is None):
            from sparsernns_tpu_torch.ops.cuda.fused_s5 import FusedS5Fn
            qat_bits = act_qat_bits(cfg)
            d, qat_scale = self.D, None
            if qat_bits is not None:
                u = fake_quant(u, cfg.ssm_act_precision)
                d = fake_quant(d, cfg.d_precision)
                if self.qat_global_scales:
                    qat_scale = self._global_state_absmax(u, lam_bar, w_b)
            return FusedS5Fn.apply(u, lam_bar[0], lam_bar[1], w_b,
                                   self._w_c(), d, self.relufication,
                                   qat_bits, qat_scale, self.block_t), None
        return self._apply_scan(u, lam_bar, w_b, None, d, b_bias, d_bias)

    def _global_state_absmax(self, u, lam_bar: Pair, w_b) -> torch.Tensor:
        """max(absmax(x_re), absmax(x_im)) of the unquantized states of the
        mixer input ``u``: the stats pass of the global-scale QAT mode, a
        matmul and the float scan kernel, without gradient."""
        with torch.no_grad():
            bu = u @ w_b
            xs = diag_ssm_scan(lam_bar, (bu[..., :self.p], bu[..., self.p:]))
            return torch.maximum(xs[0].abs().amax(), xs[1].abs().amax())

    def forward_stream(self, u: torch.Tensor, carry: Optional[Pair],
                       bn_fusion: Optional[dict] = None
                       ) -> Tuple[torch.Tensor, Pair]:
        """The carried call (streaming, and truncated backpropagation
        through time): the scan starts from ``carry`` (the state before the
        first step; None: zeros) and its final state comes back. As in the
        JAX package it is differentiable on the plain scans
        (``"associative"``, ``"sequential"``, ``"blocked"``) and not on
        the scan kernel (``"fused"``, ``"pallas"``), which raises when
        gradients are asked for."""
        if self.q_config.static_quant:
            if carry is not None:
                raise NotImplementedError(
                    "the static-quant model has no streaming carry: stream "
                    "through quantize.engine.W8A16Engine.process_chunk")
            return self._apply_static_quant(u)
        if self.bidirectional:
            raise NotImplementedError(
                "a bidirectional mixer has no streaming carry")
        if carry is None:
            zeros = u.new_zeros((u.shape[0], self.p))
            carry = (zeros, zeros)
        lam_bar, b_bar, d, b_bias, d_bias = self.fused_operands(bn_fusion)
        return self._apply_scan(u, lam_bar, self._w_b(b_bar), carry, d,
                                b_bias, d_bias)

    def _buffers_route(self, carry: Optional[Pair],
                       b_bias: Optional[Pair]) -> bool:
        """Whether the unfused mixer runs its scans inside the projections'
        buffers (``BiDiagScanFn``): bidirectional, on the scan kernel
        (``scan_mode`` ``"fused"`` or ``"pallas"``), without a carry, the
        in-scan QAT, a state relu, top-k or a folded BatchNorm's bias."""
        return (self.bidirectional and carry is None
                and self.scan_mode in ("fused", "pallas")
                and act_qat_bits(self.q_config) is None
                and not self.relufication and self.topk >= 1.0
                and b_bias is None)

    def _apply_scan(self, u, lam_bar: Pair, w_b, carry: Optional[Pair],
                    d: torch.Tensor, b_bias: Optional[Pair] = None,
                    d_bias: Optional[torch.Tensor] = None):
        """B-projection, stand-alone scan(s), state relu, C-projection: the
        JAX package's unfused mixer. Under QAT u enters the B-projection
        fake-quantized, the scans run the kernel's QAT mode (or, with
        ``scan_mode="associative"`` / ``"sequential"``, the plain scan with
        the QAT hadamards), the states are fake-quantized once more before
        the C-projection, and D ⊙ u is ``d_had`` of the two fake-quantized
        operands. ``d`` is D, or a folded BatchNorm's, whose ``b_bias`` /
        ``d_bias`` add to the B-projection and to the output. Returns (ys,
        the final state) with a carry, else (ys, the states the
        C-projection reads). The three parts run inside the spans
        ``mixer.bproj``, ``mixer.scan`` (both directions of a
        bidirectional mixer) and ``mixer.cproj`` (with the D term). On
        :meth:`_buffers_route` the states the C-projection reads are the
        columns of ``BiDiagScanFn``'s matrix."""
        cfg = self.q_config
        with span("mixer.bproj"):
            bu_cat = fake_quant(u, cfg.ssm_act_precision) @ w_b
            bu = (bu_cat[..., :self.p], bu_cat[..., self.p:])
            if b_bias is not None:
                bu = (bu[0] + b_bias[0], bu[1] + b_bias[1])
        if self._buffers_route(carry, b_bias):
            with span("mixer.scan"):
                xs_cat = BiDiagScanFn.apply(lam_bar[0], lam_bar[1], bu_cat)
            with span("mixer.cproj"):
                ys = xs_cat @ self._w_c() + self.q_ops.d_had(d, u)
            return ys, (xs_cat[..., :2 * self.p], xs_cat[..., 2 * self.p:])
        mode = (self.scan_mode
                if self.scan_mode in ("associative", "sequential", "blocked")
                else "kernel")
        had_aa, had_ax = self.q_ops.a_had
        kw = dict(mode=mode, qat_bits=act_qat_bits(cfg), block_t=self.block_t,
                  had_aa=had_aa, had_ax=had_ax)
        with span("mixer.scan"):
            if self.scan_mode == "sp":
                if self.bidirectional or carry is not None:
                    raise NotImplementedError(
                        "sequence-parallel scan does not support "
                        "bidirectional or streaming carries")
                from sparsernns_tpu_torch.parallel.seqscan import \
                    seq_chunk_scan
                xs = seq_chunk_scan(lam_bar, bu, self.seq_group)
            else:
                xs = diag_ssm_scan(lam_bar, bu, carry_init=carry, **kw)
            final = None
            if carry is not None:
                final = (xs[0][..., -1, :], xs[1][..., -1, :])
            if self.relufication:
                xs = self._state_act(xs)
            if self.bidirectional:
                count("bidir_unfused")
                # as in the JAX package, the reverse states are not
                # relufied before the concatenation
                rev = diag_ssm_scan(lam_bar, bu, reverse=True, **kw)
                xs = (torch.cat([xs[0], rev[0]], dim=-1),
                      torch.cat([xs[1], rev[1]], dim=-1))
        with span("mixer.cproj"):
            bits = cfg.ssm_act_precision
            xs_cat = torch.cat([fake_quant(xs[0], bits),
                                fake_quant(xs[1], bits)], dim=-1)
            ys = xs_cat @ self._w_c() + self.q_ops.d_had(d, u)
            if d_bias is not None:
                ys = ys + d_bias
        return ys, (xs if carry is None else final)

    def _state_act(self, xs: Pair) -> Pair:
        """The relufied states' activation: relu, or with top-k a relu
        top-k of ``int(topk * P)`` on each half (exact top-k raises, as in
        the JAX package)."""
        if self.topk < 1.0:
            if not self.approx_topk:
                raise NotImplementedError("exact top-k not implemented")
            k = int(self.topk * xs[0].shape[-1])
            return relu_top_k_sparsity(xs[0], k), relu_top_k_sparsity(xs[1], k)
        return torch.relu(xs[0]), torch.relu(xs[1])

    # ---------------- static-quant path ----------------

    def _state_requant(self):
        """The per-step state requantizer from the ``quant_xt`` scales, or
        None. While calibrating it uses the observers' running scales, and
        only once they have seen a non-zero state: requantizing with the
        eps scale of an observer that saw nothing would clip every state,
        the observers would only ever see clipped states, and the scale
        could never grow. So the first batch runs unclipped."""
        q_re, q_im = self.quant_xt.quant_real, self.quant_xt.quant_imag
        bits = self.q_config.ssm_act_precision
        if self.q_config.calibrating:
            absmax = torch.maximum(q_re.observed_absmax(),
                                   q_im.observed_absmax())
            if not (torch.isfinite(absmax) and absmax > 0.0):
                return None
            s_re, s_im = q_re.calibration_scale(), q_im.calibration_scale()
        else:
            s_re, s_im = q_re.scale, q_im.scale
        return lambda x: (quant_dequant(x[0], s_re, 0.0, bits),
                          quant_dequant(x[1], s_im, 0.0, bits))

    def _apply_static_quant(self, u: torch.Tensor
                            ) -> Tuple[torch.Tensor, Pair]:
        lam_bar, b_bar = self.discretized()
        u_q = self.quant_ut(u)
        b_bar = self.quant_b(*b_bar)
        lam_q = self.quant_a(*lam_bar)
        c_re, c_im = self.quant_c(*self._c_tilde())

        bu_cat = u_q @ self._w_b(b_bar)
        bu = self.quant_but(bu_cat[..., :self.p], bu_cat[..., self.p:])
        xs, final = sequential_diag_scan(
            lam_q, bu, state_requant=self._state_requant())
        self.quant_xt(*xs)      # feeds the observers while calibrating
        if self.relufication:
            xs = (torch.relu(xs[0]), torch.relu(xs[1]))
        ys = torch.cat(xs, dim=-1) @ torch.cat([c_re.T, -c_im.T], dim=0)
        if self.conj_sym:
            ys = 2.0 * ys
        return self.quant_yt(ys + self.quant_d(self.D) * u_q), final
