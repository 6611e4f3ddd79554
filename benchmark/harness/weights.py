"""Random weights of an NDNS configuration, made on the device from the
seed: one uniform and one normal draw of a ``torch.Generator`` on the
device, cut into the leaves, then the BatchNorm running statistics set to
the statistics the reference model's norms see on a slice of the inputs
(what a trained model's running statistics converge to). Both sides get
the same dict; leaf names follow the program's module paths."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.harness.seeds import derive
from benchmark.reference import ndns

# (name, shape, kind, a, b): normal a + b * N(0, 1); uniform in [a, b);
# loguniform exp(U[log a, log b))
Leaf = Tuple[str, tuple, str, float, float]


def leaves(recipe: dict, d_io: int, init: dict) -> List[Leaf]:
    h = recipe["d_model"]
    p = recipe["ssm_size_base"] // 2 if recipe.get("conj_sym", True) \
        else recipe["ssm_size_base"]
    out: List[Leaf] = [
        ("encoder.encoder.weight", (h, d_io), "normal", 0.0,
         1 / math.sqrt(d_io)),
        ("encoder.encoder.bias", (h,), "normal", 0.0, init["bias_std"]),
    ]
    for i in range(recipe["n_layers"]):
        pre = f"encoder.layers.{i}."
        out += [
            (pre + "mixer.Lambda_re", (p,), "uniform", *init["lambda_re"]),
            (pre + "mixer.Lambda_im", (p,), "uniform", *init["lambda_im"]),
            (pre + "mixer.B", (p, h, 2), "normal", 0.0, 1 / math.sqrt(2 * h)),
            (pre + "mixer.C", (h, p, 2), "normal", 0.0, init["c_std"]),
            (pre + "mixer.D", (h,), "normal", 0.0, 1.0),
            (pre + "mixer.log_step", (p, 1), "loguniform",
             recipe.get("dt_min", 0.001), recipe.get("dt_max", 0.1)),
            (pre + "out2.weight", (h, h), "normal", 0.0, 1 / math.sqrt(h)),
            (pre + "out2.bias", (h,), "normal", 0.0, init["bias_std"]),
            (pre + "norm.weight", (h,), "normal", 1.0, init["norm_std"]),
            (pre + "norm.bias", (h,), "normal", 0.0, init["norm_std"]),
        ]
    out += [
        ("decoder.weight", (d_io, h), "normal", 0.0, 1 / math.sqrt(h)),
        ("decoder.bias", (d_io,), "normal", 0.0, init["bias_std"]),
    ]
    return out


@torch.no_grad()
def make_weights(recipe: dict, d_io: int, init: dict, seed: int, device,
                 stats_input: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every leaf from ``seed``, then each norm's running statistics from
    the reference model on ``stats_input`` (B, L, F) features."""
    spec = leaves(recipe, d_io, init)
    sizes = [math.prod(s) for _, s, _, _, _ in spec]
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    normal = torch.randn(sum(sizes), generator=g, device=device)
    unif = torch.rand(sum(sizes), generator=g, device=device)
    w, at = {}, 0
    for (name, shape, kind, a, b), n in zip(spec, sizes):
        if kind == "normal":
            v = a + b * normal[at:at + n]
        elif kind == "uniform":
            v = a + (b - a) * unif[at:at + n]
        else:
            v = torch.exp(math.log(a) + (math.log(b) - math.log(a))
                          * unif[at:at + n])
        w[name] = v.reshape(shape).clone()
        at += n
    for i in range(recipe["n_layers"]):
        pre = f"encoder.layers.{i}.norm."
        w[pre + "running_mean"] = torch.zeros(recipe["d_model"], device=device)
        w[pre + "running_var"] = torch.ones(recipe["d_model"], device=device)
    for i, (mean, var) in enumerate(ndns.running_stats(w, stats_input)):
        w[f"encoder.layers.{i}.norm.running_mean"] = mean.clone()
        w[f"encoder.layers.{i}.norm.running_var"] = var.clone()
    return w


def param_names(w: Dict[str, torch.Tensor]) -> List[str]:
    """The trained leaves: all but the norms' running statistics."""
    return [k for k in w if "running_" not in k]
