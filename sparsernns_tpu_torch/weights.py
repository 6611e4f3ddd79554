"""Carry weights between the JAX package's model variables and the port.

:func:`from_flax` takes the ``params`` and ``batch_stats`` nested dicts of
one of the JAX package's models (the regression, classification or
retrieval head) as numpy arrays and returns the ``state_dict`` of the
port's counterpart (``models/seq_model.py``), for any number of layers,
any GLU variant, BatchNorm (with or without its scale and bias) or
LayerNorm, float or static-quant (a frozen tree's ``scale`` leaves become
the quantizers' ``scale`` buffers). The retrieval decoder's denses keep
flax's automatic names (``QDense_0``, ``QDense_1``). :func:`to_flax` is the inverse: a model's state under
the JAX package's names, which for a calibrated model is the frozen tree
(scales kept, observers dropped). Frozen trees of the two packages are
therefore interchangeable. :func:`grads_to_flax` gives the gradients that
a backward pass left on the model's parameters under the same names and
layouts, so that gradients and updated parameters compare leaf by leaf
with the JAX package's.

Dense kernels (in, out) are ``nn.Linear`` weights (out, in); norm
scale/bias are ``weight``/``bias``; BatchNorm mean/var are
``running_mean``/``running_var``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LAYER = re.compile(r"layers_(\d+)")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def flat_leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from flat_leaves(val, path + (key,))
        else:
            yield path + (key,), val


def from_flax(params: Mapping, batch_stats: Mapping
              ) -> Dict[str, torch.Tensor]:
    """JAX model variables (numpy leaves) -> port state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in flat_leaves(params):
        *mods, name = (_LAYER.sub(r"layers.\1", p) for p in path)
        val = _t(leaf)
        if name == "kernel":
            name, val = "weight", val.T.contiguous()
        elif name == "scale" and mods[-1] == "norm":
            name = "weight"
        out[".".join([*mods, name])] = val
    for path, leaf in flat_leaves(batch_stats or {}):
        *mods, name = (_LAYER.sub(r"layers.\1", p) for p in path)
        if mods[-1] == "norm" and name in ("mean", "var"):
            prefix = ".".join(mods)
            out[f"{prefix}.running_{name}"] = _t(leaf)
            out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return out


def to_flax(model: torch.nn.Module
            ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Port model -> (params, batch_stats) nested dicts of numpy arrays
    under the JAX package's names. Quantizer ``scale`` buffers go into
    ``params`` and observer state is dropped, so for a calibrated model
    this is the frozen tree."""
    return _flax_trees(model.state_dict().items())


def grads_to_flax(model: torch.nn.Module) -> Dict[str, Any]:
    """The ``.grad`` of every parameter that has one, as the JAX package's
    ``params`` tree of numpy arrays (dense kernels transposed back to
    (in, out))."""
    params, _ = _flax_trees((name, p.grad) for name, p in
                            model.named_parameters() if p.grad is not None)
    return params


def flax_path(key: str) -> Tuple[Tuple[str, ...], bool]:
    """A port ``state_dict`` name -> (its path in the JAX package's tree,
    whether the port's tensor is the transpose of the JAX leaf: a dense
    ``weight`` (out, in) against the flax ``kernel`` (in, out))."""
    *mods, name = key.split(".")
    transposed = False
    if name == "weight" and mods[-1] == "norm":
        name = "scale"
    elif name == "weight":
        name, transposed = "kernel", True
    elif name in ("running_mean", "running_var"):
        name = name[len("running_"):]
    path = re.sub(r"layers\.(\d+)", r"layers_\1", ".".join(mods))
    return (*path.split("."), name), transposed


def _flax_trees(items) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, val in items:
        *mods, name = key.split(".")
        if "observer" in mods or name == "num_batches_tracked":
            continue
        tree = stats if name.startswith("running_") else params
        (*path, name), transposed = flax_path(key)
        arr = val.detach().cpu().numpy()
        for part in path:
            tree = tree.setdefault(part, {})
        tree[name] = np.array(arr.T if transposed else arr, order="C")
    return params, stats
