"""Run configuration with JSON recipe overlay (counterpart of
``sparsernns_tpu/utils/config.py``), reduced to the fields the serving
path reads plus the training fields the repo's recipes set."""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class RunConfig:
    # --- dataset ---
    dataset: str = "ndns"
    bsz: int = 32
    synthetic_data: bool = False
    synthetic_size: int = 64
    synthetic_seconds: float = 30.0
    logger: str = "jsonl"

    # --- model ---
    n_layers: int = 3
    d_model: int = 192
    ssm_size_base: int = 256
    blocks: int = 16
    C_init: str = "lecun_normal"
    discretization: str = "zoh"
    conj_sym: bool = True
    clip_eigs: bool = True
    bidirectional: bool = False
    dt_min: float = 0.001
    dt_max: float = 0.1
    prenorm: bool = True
    batchnorm: bool = True
    glu_variant: str = "half1"
    relufication: bool = False
    scan_mode: str = "fused"            # the float port runs only "fused"

    # --- quantized conversion and serving (quantize/convert.py) ---
    convert_quantization: str = "w8a16"
    block_t: Optional[int] = None       # engine time block; None -> 512
    engine_mxu16: bool = False
    engine_route: str = "auto"
    calibrate_quant: bool = True
    validate_static_quant: bool = True
    validate_engine: bool = True

    # --- training (read by the training port; recipes set them) ---
    p_dropout: float = 0.1
    seed: int = 1919
    epochs: int = 50
    lr_factor: float = 4.0
    weight_decay: float = 0.04
    opt_config: str = "noBCdecay"
    pruning: str = "no_prune"

    def with_recipe(self, path: str) -> "RunConfig":
        """Overlay a JSON recipe; unknown keys raise."""
        with open(path) as f:
            recipe = json.load(f)
        known = {f.name for f in dataclasses.fields(self)}
        unknown = set(recipe) - known
        if unknown:
            raise ValueError(f"unknown recipe keys: {sorted(unknown)}")
        return dataclasses.replace(self, **recipe)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
