"""Post-training quantization pipeline, reduced (counterpart of
``sparsernns_tpu/quantize/convert.py``).

Ported stages, each gated by its config flag, over the synthetic loader:

  re-apply the pruning masks -> calibrate (observers over the validation
  set) -> freeze scales -> [validate_static_quant] -> [validate_engine]

Not ported yet: checkpoint restore and the versioned artifact store, the
baseline / naive-scan / fake-quant validations and both finetuning stages.
The float model and its masks are therefore passed in by the caller.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from sparsernns_tpu_torch.data.ndns import create_ndns_dataset
from sparsernns_tpu_torch.fxp.derive import FxpModelConfig
from sparsernns_tpu_torch.ops.stft import stft_splitter
from sparsernns_tpu_torch.quantize.calibrate import calibrate
from sparsernns_tpu_torch.quantize.config import quantization_recipes
from sparsernns_tpu_torch.quantize.engine import W8A16Engine
from sparsernns_tpu_torch.train.loop import build_model
from sparsernns_tpu_torch.train.pruning import Masks, masked_state_dict
from sparsernns_tpu_torch.train.losses import (STFT_MAG_MEAN,
                                               ndns_loss_from_mask_tm)
from sparsernns_tpu_torch.train.steps import make_ndns_eval_step
from sparsernns_tpu_torch.utils.config import RunConfig
from sparsernns_tpu_torch.weights import from_flax


def engine_from_frozen(cfg: RunConfig, frozen_params, frozen_stats,
                       device="cuda", **engine_kw) -> W8A16Engine:
    """The serving engine of ``cfg`` over a frozen tree."""
    q_config = quantization_recipes[cfg.convert_quantization](
        static_quant=True, calibrating=False)
    model_cfg = FxpModelConfig.infer(
        frozen_params, glu_variant=cfg.glu_variant,
        relufication=cfg.relufication, prenorm=cfg.prenorm,
        clip_eigs=cfg.clip_eigs, conj_sym=cfg.conj_sym,
        discretization=cfg.discretization, topk=cfg.topk,
        approx_topk=cfg.approx_topk)
    kw = dict(block_t=cfg.block_t, mxu16=cfg.engine_mxu16,
              route=cfg.engine_route, device=device)
    kw.update(engine_kw)
    return W8A16Engine(frozen_params, frozen_stats, q_config, model_cfg,
                       **kw)


def _features(noisy, clean, device):
    """Host audio -> (noisy_mag, noisy_phase, clean_mag, clean) on
    ``device``, spectra (B, F, L)."""
    noisy = torch.as_tensor(noisy, device=device)
    clean = torch.as_tensor(clean, device=device)
    noisy_mag, noisy_phase = stft_splitter(noisy)
    clean_mag, _ = stft_splitter(clean)
    return noisy_mag, noisy_phase, clean_mag, clean


def _validate(step, loader, device) -> Dict[str, float]:
    losses, snrs = [], []
    for noisy, clean in loader:
        m = step(*_features(noisy, clean, device))
        losses.append(float(m["loss"]))
        snrs.append(float(m["si_snr"]))
    return {"loss": float(np.mean(losses)), "si_snr": float(np.mean(snrs))}


def convert(cfg: RunConfig, model: torch.nn.Module,
            masks: Optional[Masks] = None) -> Dict[str, Any]:
    """Run the ported stages on the float ``model`` of ``cfg``, with its
    weights times the pruning ``masks`` (a pruned run's
    ``TrainState.masks``; the model itself is left as it is). Returns the
    per-stage metrics plus ``frozen_params`` / ``frozen_stats`` (nested
    dicts of numpy arrays) when calibration ran."""
    results: Dict[str, Any] = {}
    device = next(model.parameters()).device
    _, valloader, _, n_out, _, d_input, _ = create_ndns_dataset(
        cfg.bsz, seed=cfg.seed, synthetic=True,
        synthetic_size=cfg.synthetic_size,
        synthetic_length=int(cfg.synthetic_seconds * 16000))
    q_recipe = quantization_recipes[cfg.convert_quantization]

    frozen_params = frozen_stats = None
    if cfg.calibrate_quant:
        cal_model = build_model(
            cfg, d_input, n_out, device=device,
            q_config=q_recipe(static_quant=True, calibrating=True),
            scan_mode="sequential")

        def batches():
            for noisy, clean in valloader:
                noisy_mag = _features(noisy, clean, device)[0]
                yield (noisy_mag - STFT_MAG_MEAN).transpose(1, 2)

        frozen_params, frozen_stats = calibrate(
            cal_model, masked_state_dict(model, masks), batches())
        results.update(calibrated=True, frozen_params=frozen_params,
                       frozen_stats=frozen_stats)

    if cfg.validate_static_quant and frozen_params is not None:
        sq_model = build_model(
            cfg, d_input, n_out, device=device,
            q_config=q_recipe(static_quant=True, calibrating=False),
            scan_mode="sequential")
        sq_model.load_state_dict(from_flax(frozen_params, frozen_stats))
        results["static_quant"] = _validate(
            make_ndns_eval_step(sq_model), valloader, device)

    if cfg.validate_engine and frozen_params is not None:
        engine = engine_from_frozen(cfg, frozen_params, frozen_stats,
                                    device=device)

        def step(noisy_mag, noisy_phase, clean_mag, clean):
            noisy_mag_tm = noisy_mag.transpose(1, 2)
            loss, snr, _ = ndns_loss_from_mask_tm(
                engine(noisy_mag_tm - STFT_MAG_MEAN), noisy_mag_tm,
                noisy_phase.transpose(1, 2), clean_mag.transpose(1, 2),
                clean)
            return {"loss": loss, "si_snr": snr}

        results["engine"] = _validate(step, valloader, device)
    return results
