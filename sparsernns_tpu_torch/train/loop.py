"""Model assembly from a :class:`RunConfig` (counterpart of
``sparsernns_tpu/train/loop.py`` ``build_model``)."""

from __future__ import annotations

from typing import Optional

import torch

from sparsernns_tpu_torch.models.seq_model import RegressionModel
from sparsernns_tpu_torch.models.ssm import S5SSM
from sparsernns_tpu_torch.models.ssm_init import (blocked_dplr_init,
                                                  lecun_normal)
from sparsernns_tpu_torch.quantize.config import QuantizationConfig
from sparsernns_tpu_torch.utils.config import RunConfig


def build_model(cfg: RunConfig, d_input: int, d_output: int,
                training: bool = False, device="cuda",
                seed: Optional[int] = None,
                q_config: Optional[QuantizationConfig] = None,
                scan_mode: Optional[str] = None) -> RegressionModel:
    """The NDNS regression model of ``cfg`` in eval mode on ``device``,
    with parameters drawn from ``seed`` (default ``cfg.seed``) by the
    JAX package's initializer distributions.

    ``q_config`` with ``static_quant`` builds the static-quant model (the
    calibration model when it is ``calibrating``); it runs the sequential
    scan, so ``scan_mode`` must then be ``"sequential"``, as the JAX
    package's conversion pipeline passes it. The float model runs only
    ``"fused"``."""
    if training:
        raise NotImplementedError("training is not ported yet")
    if cfg.dataset != "ndns":
        raise NotImplementedError(f"dataset {cfg.dataset!r}: only ndns")
    q_config = q_config or QuantizationConfig.none()
    scan_mode = scan_mode or cfg.scan_mode
    if q_config.static_quant:
        if scan_mode != "sequential":
            raise NotImplementedError(
                "the static-quant model requantizes the state every step: "
                "build it with scan_mode='sequential'")
    elif q_config.any_quantized:
        raise NotImplementedError(
            "dynamic fake-quant (QAT) models are not ported yet")
    elif scan_mode != "fused":
        raise NotImplementedError(
            f"scan_mode {scan_mode!r}: the float port runs only 'fused'")
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    init = blocked_dplr_init(cfg.ssm_size_base, cfg.blocks, cfg.conj_sym)

    def make_mixer():
        return S5SSM(
            init["Lambda"], init["V"], init["Vinv"], h=cfg.d_model,
            p=init["P"], c_init=cfg.C_init,
            discretization=cfg.discretization, dt_min=cfg.dt_min,
            dt_max=cfg.dt_max, conj_sym=cfg.conj_sym,
            clip_eigs=cfg.clip_eigs, bidirectional=cfg.bidirectional,
            relufication=cfg.relufication, generator=gen,
            q_config=q_config)

    model = RegressionModel(
        make_mixer, d_input, d_output, cfg.n_layers, cfg.d_model,
        q_config=q_config, glu_variant=cfg.glu_variant,
        relufication=cfg.relufication, batchnorm=cfg.batchnorm,
        prenorm=cfg.prenorm)
    # dense layers: lecun_normal kernel, zero bias (as in the JAX package)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Linear):
                k = lecun_normal((mod.in_features, mod.out_features), gen)
                mod.weight.copy_(k.T)
                mod.bias.zero_()
    return model.to(device).eval()
