"""Build the integer (fxp) model from a calibrated static-quant checkpoint
(counterpart of ``sparsernns_tpu/fxp/derive.py``): the model
hyperparameter record, the nested-dict lookup, the host-side
discretization the serving engine shares, and :func:`build_fxp_model`.

- weight formats come from the frozen calibration scales where there is
  one, else are fit to the (discretized, BN-folded) weight values
  (``spec_for``);
- activation formats come from the calibration scales of the FakeQuant
  observers (pow2 scale -> exponent), looked up in params (frozen) or
  batch_stats (calibrating), else from the raw observer ranges;
- target bit widths come from the QuantizationConfig recipe.

Everything is packed on the host in numpy, then the model moves to the
caller's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from sparsernns_tpu_torch.fxp.model import (FxpBatchNorm,
                                            FxpClassificationModel,
                                            FxpDense, FxpRegressionModel,
                                            FxpSequenceLayer, FxpSpec,
                                            FxpSSM, FxpSSMSpecs,
                                            FxpStackedEncoder,
                                            exp_from_scale, spec_for)
from sparsernns_tpu_torch.quantize.config import QuantizationConfig


@dataclasses.dataclass(frozen=True)
class FxpModelConfig:
    """Static model hyperparameters the engine needs, inferred from the
    checkpoint shapes where possible."""

    n_layers: int
    d_model: int
    ssm_size: int  # P (after conj-sym halving)
    d_input: int
    d_output: int
    conj_sym: bool = True
    clip_eigs: bool = True
    discretization: str = "zoh"
    step_rescale: float = 1.0
    glu_variant: str = "half1"
    prenorm: bool = True
    relufication: bool = True
    fuse_batchnorm_linear: bool = False
    topk: float = 1.0
    approx_topk: bool = False
    task: str = "regression"  # or "classification"

    @staticmethod
    def infer(params: Dict[str, Any], **overrides) -> "FxpModelConfig":
        enc = params["encoder"]
        layers = [k for k in enc if k.startswith("layers_")]
        mixer = enc["layers_0"]["mixer"]
        p, h, _ = np.asarray(mixer["B"]).shape
        d_input = np.asarray(enc["encoder"]["kernel"]).shape[0]
        d_output = np.asarray(params["decoder"]["kernel"]).shape[1]
        kw = dict(n_layers=len(layers), d_model=h, ssm_size=p,
                  d_input=d_input, d_output=d_output)
        kw.update(overrides)
        return FxpModelConfig(**kw)


def _get(tree: Dict[str, Any], *path, default=None):
    cur = tree
    for key in path:
        if cur is None or key not in cur:
            return default
        cur = cur[key]
    return cur


def _scale(params, stats, *path) -> Optional[float]:
    """Scale for a FakeQuant module at ``path``: frozen (params) first,
    then the calibration copy (batch_stats)."""
    s = _get(params, *path, "scale")
    if s is None:
        s = _get(stats, *path, "scale")
    if s is None:
        return None
    return float(np.asarray(s))


def _act_spec(params, stats, path, bits: int,
              fallback_exp: Optional[int] = None) -> FxpSpec:
    s = _scale(params, stats, *path)
    if s is None:
        # no frozen / calibrated scale: one from the raw observer range
        obs = _get(stats, *path, "observer")
        if obs is not None:
            absmax = float(np.maximum(np.abs(obs["observer_min"]),
                                      np.abs(obs["observer_max"])).max())
            if absmax > 0 and np.isfinite(absmax):
                qmax = 2.0 ** (bits - 1) - 1.0
                s = 2.0 ** round(np.log2(absmax / qmax))
    if s is None:
        if fallback_exp is None:
            raise KeyError(f"no calibration scale at {'/'.join(path)}")
        return FxpSpec(bits, fallback_exp)
    return FxpSpec(bits, exp_from_scale(s))


def _discretize(mixer_params, cfg: FxpModelConfig):
    """Float discretization of one mixer's parameters, in float64 and then
    cast to float32 (pure numpy: engine packing is host-side). Returns
    (lam_bar (P,) pair, b_bar (P, H) pair, c_tilde (H, P) pair, d (H,));
    a bidirectional mixer's C1 / C2 are concatenated along P, (H, 2P)."""
    lam_re = np.asarray(mixer_params["Lambda_re"], np.float64)
    lam_im = np.asarray(mixer_params["Lambda_im"], np.float64)
    if cfg.clip_eigs:
        lam_re = np.minimum(lam_re, -1e-4)
    lam = lam_re + 1j * lam_im
    b = np.asarray(mixer_params["B"], np.float64)
    b_c = b[..., 0] + 1j * b[..., 1]
    log_step = np.asarray(mixer_params["log_step"], np.float64)
    step = cfg.step_rescale * np.exp(log_step[:, 0])
    if cfg.discretization == "zoh":
        lam_bar_c = np.exp(lam * step)
        b_bar_c = ((lam_bar_c - 1.0) / lam)[:, None] * b_c
    else:  # bilinear
        bl = 1.0 / (1.0 - 0.5 * step * lam)
        lam_bar_c = bl * (1.0 + 0.5 * step * lam)
        b_bar_c = (bl * step)[:, None] * b_c
    lam_bar = (lam_bar_c.real.astype(np.float32),
               lam_bar_c.imag.astype(np.float32))
    b_bar = (b_bar_c.real.astype(np.float32),
             b_bar_c.imag.astype(np.float32))
    if "C" in mixer_params:
        c = np.asarray(mixer_params["C"])
        c_tilde = (c[..., 0], c[..., 1])
    else:
        c1 = np.asarray(mixer_params["C1"])
        c2 = np.asarray(mixer_params["C2"])
        c_tilde = (np.concatenate([c1[..., 0], c2[..., 0]], -1),
                   np.concatenate([c1[..., 1], c2[..., 1]], -1))
    d = np.asarray(mixer_params["D"])
    return lam_bar, b_bar, c_tilde, d


def build_fxp_model(
    params: Dict[str, Any],
    batch_stats: Dict[str, Any],
    q_config: QuantizationConfig,
    model_cfg: Optional[FxpModelConfig] = None,
    spec_overrides: Optional[Dict[str, FxpSpec]] = None,
    device="cuda",
    **cfg_overrides,
):
    """Calibrated checkpoint -> FxpRegressionModel / FxpClassificationModel
    on ``device``.

    ``params`` / ``batch_stats`` are the static-quant model's variable
    trees (nested dicts of numpy arrays, the JAX package's layout; scales
    frozen into params, or still in batch_stats right after calibration).

    ``spec_overrides`` maps derived-spec names to FxpSpec: "in",
    "enc_out", "act", "dec_in", "dec_out", and per layer
    "layers_{i}.{u|bu_re|bu_im|x_re|x_im|y}".
    """
    if model_cfg is None:
        model_cfg = FxpModelConfig.infer(params, **cfg_overrides)
    cfg = model_cfg
    if cfg.topk < 1.0 and not cfg.approx_topk:
        # only the approx_max_k top-k exists, as in the float model
        raise NotImplementedError("exact top-k not implemented")
    act_bits = q_config.non_ssm_act_precision or 16
    ssm_act_bits = q_config.ssm_act_precision or 16
    w_bits = q_config.non_ssm_precision or 8

    ov = spec_overrides or {}
    enc_p = params["encoder"]
    enc_s = batch_stats.get("encoder", {}) if batch_stats else {}

    # --- encoder dense ---
    in_spec = ov.get("in") or _act_spec(
        enc_p, enc_s, ("encoder", "quant_input"), act_bits,
        fallback_exp=act_bits - 2)
    enc_out_spec = ov.get("enc_out") or _act_spec(
        enc_p, enc_s, ("encoder", "quant_output"), act_bits,
        fallback_exp=act_bits - 3)
    encoder_dense = FxpDense(
        np.asarray(_get(enc_p, "encoder", "kernel")),
        np.asarray(_get(enc_p, "encoder", "bias")),
        in_spec, w_bits, enc_out_spec)

    # Residual-stream format where no layer has its own observer: the
    # coarser of (encoder output, decoder input), one bit of headroom.
    dec_in_probe = ov.get("dec_in") or _act_spec(
        params, batch_stats, ("decoder", "quant_input"),
        act_bits, fallback_exp=enc_out_spec.exp)
    act_spec = ov.get("act") or FxpSpec(
        act_bits, max(0, min(enc_out_spec.exp, dec_in_probe.exp) - 1))

    layers = []
    for i in range(cfg.n_layers):
        lp = enc_p[f"layers_{i}"]
        ls = enc_s.get(f"layers_{i}", {})
        mp = lp["mixer"]
        ms = ls.get("mixer", {})

        # per-layer residual format from its calibrated observer
        s_res = _scale(lp, ls, "quant_residual")
        layer_act_spec = (FxpSpec(act_bits, exp_from_scale(s_res))
                          if s_res is not None else act_spec)

        lam_bar, b_bar, c_tilde, d = _discretize(mp, cfg)

        lk = f"layers_{i}"
        u_spec = ov.get(f"{lk}.u") or _act_spec(
            mp, ms, ("quant_ut",), ssm_act_bits,
            fallback_exp=ssm_act_bits - 3)
        bu_specs = (
            ov.get(f"{lk}.bu_re") or _act_spec(
                mp, ms, ("quant_but", "quant_real"), ssm_act_bits,
                fallback_exp=ssm_act_bits - 3),
            ov.get(f"{lk}.bu_im") or _act_spec(
                mp, ms, ("quant_but", "quant_imag"), ssm_act_bits,
                fallback_exp=ssm_act_bits - 3))
        x_specs = (
            ov.get(f"{lk}.x_re") or _act_spec(
                mp, ms, ("quant_xt", "quant_real"), ssm_act_bits,
                fallback_exp=ssm_act_bits - 4),
            ov.get(f"{lk}.x_im") or _act_spec(
                mp, ms, ("quant_xt", "quant_imag"), ssm_act_bits,
                fallback_exp=ssm_act_bits - 4))
        y_spec = ov.get(f"{lk}.y") or _act_spec(
            mp, ms, ("quant_yt",), ssm_act_bits,
            fallback_exp=ssm_act_bits - 3)

        def _wspec(path, bits, values, mp=mp, ms=ms):
            """Weight format: the frozen calibration scale's grid, else
            fit to the values."""
            s = _scale(mp, ms, *path)
            if s is not None:
                return FxpSpec(bits, exp_from_scale(s))
            return spec_for(values, bits)

        a_bits = q_config.a_precision or 16
        w_b_bits = q_config.b_precision or 8
        w_c_bits = q_config.c_precision or 8
        specs = FxpSSMSpecs(
            a=(_wspec(("quant_a", "quant_real"), a_bits, lam_bar[0]),
               _wspec(("quant_a", "quant_imag"), a_bits, lam_bar[1])),
            b=(_wspec(("quant_b", "quant_real"), w_b_bits, b_bar[0]),
               _wspec(("quant_b", "quant_imag"), w_b_bits, b_bar[1])),
            c=(_wspec(("quant_c", "quant_real"), w_c_bits, c_tilde[0]),
               _wspec(("quant_c", "quant_imag"), w_c_bits, c_tilde[1])),
            d=_wspec(("quant_d",), q_config.d_precision or 8, d),
            u=u_spec, bu=bu_specs, x=x_specs, y=y_spec)

        norm = None
        if lp.get("norm") is not None or ls.get("norm") is not None:
            norm = FxpBatchNorm(
                mean=np.asarray(_get(ls, "norm", "mean",
                                     default=np.zeros(cfg.d_model))),
                var=np.asarray(_get(ls, "norm", "var",
                                    default=np.ones(cfg.d_model))),
                scale=np.asarray(_get(lp, "norm", "scale",
                                      default=np.ones(cfg.d_model))),
                bias=np.asarray(_get(lp, "norm", "bias",
                                     default=np.zeros(cfg.d_model))),
                eps=1e-5, in_spec=layer_act_spec, out_spec=u_spec)

        # state relufication (relu on xs before C) mirrors the mixer's
        ssm = FxpSSM(lam_bar, b_bar, c_tilde, d, specs,
                     conj_sym=cfg.conj_sym,
                     relufication=cfg.relufication, topk=cfg.topk)

        out2 = out1 = None
        if cfg.glu_variant in ("full", "half1", "half2"):
            out2 = FxpDense(
                np.asarray(_get(lp, "out2", "kernel")),
                np.asarray(_get(lp, "out2", "bias")),
                _act_spec(lp, ls, ("out2", "quant_input"), act_bits,
                          fallback_exp=y_spec.exp),
                w_bits,
                _act_spec(lp, ls, ("out2", "quant_output"), act_bits,
                          fallback_exp=act_bits - 4))
        if cfg.glu_variant == "full":
            out1 = FxpDense(
                np.asarray(_get(lp, "out1", "kernel")),
                np.asarray(_get(lp, "out1", "bias")),
                _act_spec(lp, ls, ("out1", "quant_input"), act_bits,
                          fallback_exp=y_spec.exp),
                w_bits,
                _act_spec(lp, ls, ("out1", "quant_output"), act_bits,
                          fallback_exp=act_bits - 4))

        # the GLU multiply's operand formats from the frozen
        # QuantizedMultiply scales (quant_left / quant_right)
        mult_specs = None
        s_left = _scale(lp, ls, "mult_gate", "quant_left")
        s_right = _scale(lp, ls, "mult_gate", "quant_right")
        if s_left is not None and s_right is not None:
            mult_specs = (FxpSpec(act_bits, exp_from_scale(s_left)),
                          FxpSpec(act_bits, exp_from_scale(s_right)))

        layers.append(FxpSequenceLayer(
            ssm=ssm, norm=norm, out2=out2, out1=out1,
            glu_variant=cfg.glu_variant, act_spec=layer_act_spec,
            relufication=cfg.relufication, prenorm=cfg.prenorm,
            mult_specs=mult_specs, topk=cfg.topk))

    dec_in = ov.get("dec_in") or _act_spec(
        params, batch_stats, ("decoder", "quant_input"),
        act_bits, fallback_exp=act_spec.exp)
    dec_out = ov.get("dec_out") or _act_spec(
        params, batch_stats, ("decoder", "quant_output"),
        act_bits, fallback_exp=act_bits - 4)
    decoder = FxpDense(
        np.asarray(_get(params, "decoder", "kernel")),
        np.asarray(_get(params, "decoder", "bias")),
        dec_in, w_bits, dec_out)

    encoder = FxpStackedEncoder(encoder_dense, layers,
                                relufication=cfg.relufication,
                                topk=cfg.topk)
    head = (FxpClassificationModel if cfg.task == "classification"
            else FxpRegressionModel)
    return head(encoder, decoder, in_spec).to(device)
