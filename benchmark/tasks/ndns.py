"""Task ``ndns``: speech denoising with the N-DNS regression model.

The run's data is a pool of (noisy, clean) clips made by the mix's
generator (``synthetic_ndns``). The weights are the recipe's leaves drawn
from the seed (``harness/weights.draw``), then the BatchNorm running
statistics set to the statistics the reference model's norms see on a
slice of the noisy clips' features (what a trained model's running
statistics converge to). Where the configuration calibrates, its
calibration inputs are frame slices of the first clips' features. The
shape is ``cost/model.Shape`` at the clips' frame count.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.cost.model import Shape
from benchmark.harness.weights import Leaf, draw
from benchmark.reference import ndns
from benchmark.tasks import Prepared

#: small sizes for the CPU: the recipe's structure at width 16, 8 states,
#: 2 layers; clips of 0.2 s (26 frames); engine block 8
TINY = {"recipe": {"d_model": 16, "ssm_size_base": 16, "blocks": 2,
                   "n_layers": 2},
        "mix": {"clip_seconds": 0.2, "pool_clips": 48, "batch": 4},
        "config": {"norm_stats": {"clips": 4, "frames": 16},
                   "calibration": {"clips": 4, "slices": [[0, 10], [10, 20]]},
                   "engine": {"block_t": 8, "act_dtype": "bfloat16",
                              "route": "auto"}}}


def leaves(recipe: dict, d_io: int, init: dict) -> List[Leaf]:
    """The model's trained leaves, by the program's module paths."""
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
    w = draw(leaves(recipe, d_io, init), seed, device)
    for i in range(recipe["n_layers"]):
        pre = f"encoder.layers.{i}.norm."
        w[pre + "running_mean"] = torch.zeros(recipe["d_model"], device=device)
        w[pre + "running_var"] = torch.ones(recipe["d_model"], device=device)
    for i, (mean, var) in enumerate(ndns.running_stats(w, stats_input)):
        w[f"encoder.layers.{i}.norm.running_mean"] = mean.clone()
        w[f"encoder.layers.{i}.norm.running_var"] = var.clone()
    return w


def prepare(cell: dict, seed: int, device, generator) -> Prepared:
    """The pool of (noisy, clean) clips, the weights, the calibration
    features and the shape of a run."""
    conf, mix = cell["config_data"], cell["mix"]
    recipe = {**conf["defaults"], **conf["recipe"]}
    noisy, clean = generator.make_pool(mix, seed, device)
    ns = conf["norm_stats"]
    stats_in = ndns.features(noisy[:ns["clips"]])[0][:, :ns["frames"]]
    weights = make_weights(recipe, conf["d_io"], conf["init"], seed, device,
                           stats_in)
    cal = []
    if "calibration" in conf:
        feats = ndns.features(noisy[:conf["calibration"]["clips"]])[0]
        cal = [feats[:, a:b].contiguous()
               for a, b in conf["calibration"]["slices"]]
    frames = noisy.shape[-1] // ndns.HOP + 1
    p = recipe["ssm_size_base"] // 2
    shape = Shape(mix["batch"], frames, conf["d_io"], recipe["d_model"], p,
                  recipe["n_layers"])
    return Prepared({"noisy": noisy, "clean": clean}, weights, cal, shape)
