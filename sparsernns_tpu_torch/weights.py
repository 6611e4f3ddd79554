"""Carry weights from the JAX package's model variables into the port.

:func:`from_flax` takes the ``params`` and ``batch_stats`` nested dicts of
the JAX package's ``RegressionModel`` as numpy arrays and returns the ``state_dict`` of the port's
:class:`~sparsernns_tpu_torch.models.seq_model.RegressionModel` for any
number of layers and any GLU variant. Dense kernels (in, out) become
``nn.Linear`` weights (out, in); BatchNorm scale/bias/mean/var become
``nn.BatchNorm1d`` weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(prefix: str, leaf: Mapping, out: Dict[str, torch.Tensor]):
    out[f"{prefix}.weight"] = _t(leaf["kernel"]).T.contiguous()
    out[f"{prefix}.bias"] = _t(leaf["bias"])


def from_flax(params: Mapping, batch_stats: Mapping
              ) -> Dict[str, torch.Tensor]:
    """JAX RegressionModel variables (numpy leaves) -> port state_dict."""
    out: Dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    _dense("encoder.encoder", enc["encoder"], out)
    _dense("decoder", params["decoder"], out)
    stats = batch_stats["encoder"]
    layer_names = sorted((k for k in enc if re.fullmatch(r"layers_\d+", k)),
                         key=lambda k: int(k.split("_")[1]))
    for name in layer_names:
        i = int(name.split("_")[1])
        pre = f"encoder.layers.{i}"
        layer = enc[name]
        for key, val in layer["mixer"].items():
            out[f"{pre}.mixer.{key}"] = _t(val)
        for dense in ("out1", "out2"):
            if dense in layer:
                _dense(f"{pre}.{dense}", layer[dense], out)
        norm, norm_stats = layer["norm"], stats[name]["norm"]
        out[f"{pre}.norm.weight"] = _t(norm["scale"])
        out[f"{pre}.norm.bias"] = _t(norm["bias"])
        out[f"{pre}.norm.running_mean"] = _t(norm_stats["mean"])
        out[f"{pre}.norm.running_var"] = _t(norm_stats["var"])
        out[f"{pre}.norm.num_batches_tracked"] = torch.tensor(0)
    return out
