"""Task ``pathx``: S5 on LRA Path-X, the bidirectional classification model
over sequences of 16 384 steps of one feature, pooled to 2 classes.

The run's data is a pool of images and labels made by the mix's
generator (``synthetic_pathx``). The weights are the model's leaves drawn
from the seed (``harness/weights.draw``) at the configuration's scales,
with BatchNorm's default running statistics (a training step normalizes
with the batch's own and does not read them). The shape is
``cost/pathx.Shape``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.cost.pathx import Shape
from benchmark.harness.weights import Leaf, draw
from benchmark.tasks import Prepared

#: small sizes for the CPU: the recipe's structure at width 16, 8 states a
#: direction, 2 layers; images of 8 x 8 (L = 64), batch 4
TINY = {"recipe": {"d_model": 16, "ssm_size_base": 16, "blocks": 2,
                   "n_layers": 2},
        "mix": {"side": 8, "pool": 16, "batch": 4, "strokes": 2}}


def recipe_of(conf: dict) -> dict:
    """The configuration's recipe as it runs: the source's values over the
    assumed ones over the training script's defaults."""
    return {**conf["defaults"], **conf["assumed"]["recipe"],
            **conf["recipe"]}


def states(recipe: dict) -> int:
    """P, the complex states of one direction."""
    return recipe["ssm_size_base"] // (2 if recipe["conj_sym"] else 1)


def leaves(recipe: dict, d_in: int, classes: int, init: dict) -> List[Leaf]:
    """The model's trained leaves, by the program's module paths; C is
    (H, 2P, 2), ``complex_normal`` over both directions' states."""
    h, p = recipe["d_model"], states(recipe)
    out: List[Leaf] = [
        ("encoder.encoder.weight", (h, d_in), "normal", 0.0,
         1 / math.sqrt(d_in)),
        ("encoder.encoder.bias", (h,), "normal", 0.0, init["bias_std"]),
    ]
    for i in range(recipe["n_layers"]):
        pre = f"encoder.layers.{i}."
        out += [
            (pre + "mixer.Lambda_re", (p,), "uniform", *init["lambda_re"]),
            (pre + "mixer.Lambda_im", (p,), "uniform", *init["lambda_im"]),
            (pre + "mixer.B", (p, h, 2), "normal", 0.0, 1 / math.sqrt(2 * h)),
            (pre + "mixer.C", (h, 2 * p, 2), "normal", 0.0, init["c_std"]),
            (pre + "mixer.D", (h,), "normal", 0.0, 1.0),
            (pre + "mixer.log_step", (p, 1), "loguniform",
             recipe["dt_min"], recipe["dt_max"]),
            (pre + "out2.weight", (h, h), "normal", 0.0, 1 / math.sqrt(h)),
            (pre + "out2.bias", (h,), "normal", 0.0, init["bias_std"]),
            (pre + "norm.weight", (h,), "normal", 1.0, init["norm_std"]),
            (pre + "norm.bias", (h,), "normal", 0.0, init["norm_std"]),
        ]
    out += [
        ("decoder.weight", (classes, h), "normal", 0.0, 1 / math.sqrt(h)),
        ("decoder.bias", (classes,), "normal", 0.0, init["bias_std"]),
    ]
    return out


def make_weights(recipe: dict, d_in: int, classes: int, init: dict,
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from ``seed``, and each norm's running statistics at
    BatchNorm's defaults (zeros and ones)."""
    w = draw(leaves(recipe, d_in, classes, init), seed, device)
    for i in range(recipe["n_layers"]):
        pre = f"encoder.layers.{i}.norm."
        w[pre + "running_mean"] = torch.zeros(recipe["d_model"], device=device)
        w[pre + "running_var"] = torch.ones(recipe["d_model"], device=device)
    return w


def prepare(cell: dict, seed: int, device, generator) -> Prepared:
    """The pool of images and labels, the weights and the shape of a
    run."""
    conf, mix = cell["config_data"], cell["mix"]
    recipe = recipe_of(conf)
    inputs, labels = generator.make_pool(mix, seed, device)
    weights = make_weights(recipe, inputs.shape[-1], mix["classes"],
                           conf["init"], seed, device)
    shape = Shape(mix["batch"], inputs.shape[1], inputs.shape[-1],
                  recipe["d_model"], states(recipe), recipe["n_layers"],
                  mix["classes"])
    return Prepared({"inputs": inputs, "labels": labels}, weights, [], shape)
