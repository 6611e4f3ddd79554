"""Static-quantization calibration: observers -> frozen scales
(counterpart of ``sparsernns_tpu/quantize/calibrate.py``).

1. build the model with ``static_quant=True, calibrating=True``: every
   ``FakeQuant`` runs a ``MinMaxObserver`` and passes its input through;
2. load the trained weights and BatchNorm statistics into it;
3. run forward passes over a calibration set: the observers accumulate
   ranges and derive scales;
4. freeze: :func:`~sparsernns_tpu_torch.weights.to_flax` keeps the scales
   and drops the observers. The result loads into the
   ``calibrating=False`` model (``weights.from_flax``) and is what the
   serving engine packs.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple

import torch

from sparsernns_tpu_torch.weights import to_flax


def calibrate(cal_model: torch.nn.Module,
              trained_state: Mapping[str, torch.Tensor],
              batches: Iterable[torch.Tensor]
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load ``trained_state`` (the float model's ``state_dict``) into the
    calibration model, observe ``batches`` ((B, L, d_input) each) and
    return (frozen_params, frozen_stats) as nested dicts of numpy arrays
    under the JAX package's names."""
    missing, unexpected = cal_model.load_state_dict(trained_state,
                                                    strict=False)
    if unexpected:
        raise KeyError(f"not in the calibration model: {unexpected}")
    not_quant = [k for k in missing
                 if "quant" not in k and "mult_gate" not in k]
    if not_quant:
        raise KeyError(f"trained state lacks: {not_quant}")
    device = next(cal_model.parameters()).device
    cal_model.eval()
    with torch.no_grad():
        for batch in batches:
            cal_model(torch.as_tensor(batch, device=device))
    return to_flax(cal_model)
