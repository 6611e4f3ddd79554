"""What the serving engine needs of ``sparsernns_tpu/fxp/derive.py``: the
model hyperparameter record, the nested-dict lookup and the host-side
discretization. ``build_fxp_model`` (the integer golden engine) is not
ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np


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


def _discretize(mixer_params, cfg: FxpModelConfig):
    """Float discretization of one mixer's parameters, in float64 and then
    cast to float32 (pure numpy: engine packing is host-side). Returns
    (lam_bar (P,) pair, b_bar (P, H) pair, c_tilde (H, P) pair, d (H,))."""
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
    if "C" not in mixer_params:
        raise NotImplementedError("bidirectional mixer (C1/C2): not ported")
    c = np.asarray(mixer_params["C"])
    d = np.asarray(mixer_params["D"])
    return lam_bar, b_bar, (c[..., 0], c[..., 1]), d
