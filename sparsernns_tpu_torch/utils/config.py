"""Run configuration with JSON recipe overlay (counterpart of
``sparsernns_tpu/utils/config.py``): every field of the JAX package's
``RunConfig`` with its default and meaning, so a recipe written for the
JAX package loads here. The command line (``cli.py``) is generated from
the fields (:func:`add_config_args`, :func:`config_from_args`)."""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class RunConfig:
    # --- experiment / logging ---
    run_name: Optional[str] = None
    #: the epoch metrics' sink: "jsonl" (``metrics.jsonl`` in the
    #: checkpoint directory), "wandb" or "none" (``utils/logging.py``)
    logger: str = "jsonl"
    wandb_project: str = "sparsernns-tpu"
    checkpoint_dir: Optional[str] = None
    restore_checkpoint: bool = True
    reset_optimizer: bool = False
    #: per-epoch activation sparsity of one batch: none | val | train | both
    log_act_sparsity: str = "none"
    #: warn when an epoch's mean gradient norm exceeds this
    grad_norm_warn_threshold: float = 50.0
    #: a ``torch.profiler`` trace of the second epoch into ``profile_dir``
    profile: bool = False
    profile_dir: str = "/tmp/sparsernns_profile"

    # --- dataset ---
    #: "ndns", "synthetic-classification", "smnist" or "psmnist"
    dataset: str = "ndns"
    dir_name: Optional[str] = None      # accepted, read by no path
    bsz: int = 32
    #: gradient-accumulation microbatch size (None: full-batch step)
    microbatch: Optional[int] = None
    synthetic_data: bool = False
    synthetic_size: int = 64
    synthetic_seconds: float = 30.0

    # --- model ---
    n_layers: int = 3
    d_model: int = 192
    ssm_size_base: int = 256
    blocks: int = 16
    C_init: str = "lecun_normal"
    discretization: str = "zoh"
    #: the classification head's pooling: "pool" or "last"
    mode: str = "pool"
    activation_fn: str = "half_glu1"    # accepted, read by no path
    conj_sym: bool = True
    clip_eigs: bool = True
    bidirectional: bool = False
    dt_min: float = 0.001
    dt_max: float = 0.1
    prenorm: bool = True
    batchnorm: bool = True
    bn_momentum: float = 0.95
    batchnorm_use_bias: bool = True
    batchnorm_use_scale: bool = True
    glu_variant: str = "half1"
    #: fold each prenorm BatchNorm into its mixer's B̄ and D
    fuse_batchnorm_linear: bool = False
    relufication: bool = False
    topk: float = 1.0                   # activation top-k share (< 1: on)
    approx_topk: bool = False           # required with topk < 1 (as JAX)
    #: uniform rescale of d_model and the state size (:meth:`apply_dim_scale`)
    dim_scale: float = 1.0
    #: "associative", "fused", "pallas", "sequential" or "blocked"
    scan_mode: str = "associative"
    #: the stream between the layers of a training model: "float32", or
    #: "bfloat16" where every layer runs the whole-layer kernel with
    #: BatchNorm (the weights, gradients and statistics stay float32)
    train_stream_dtype: str = "float32"

    # --- quantization-aware training (train/loop.py build_model) ---
    quantization: str = "none"          # a quantization_recipes name
    quant_input: Optional[float] = None  # input grid exponent, or None
    #: QAT mixer kernel: one global state absmax (two-pass) instead of
    #: per-block scales
    qat_global_scales: bool = False

    # --- quantized conversion and serving (quantize/convert.py) ---
    convert_quantization: str = "w8a16"
    #: time block of the engine (None -> 512) and of the QAT scans, where
    #: it is numerics (None -> 256)
    block_t: Optional[int] = None
    engine_mxu16: bool = False
    engine_route: str = "auto"
    # the stage gates of quantize/convert.convert, in the order it runs them
    validate_baseline: bool = False
    store_activations: bool = False
    validate_naive_scan: bool = False
    validate_aqt: bool = False
    train_aqt: bool = False
    calibrate_quant: bool = True
    validate_static_quant: bool = True
    validate_engine: bool = True
    train_static_quant: bool = False
    #: epochs of each finetuning stage (train_aqt, train_static_quant)
    qaft_epochs: int = 10

    # --- regularization / optimization ---
    p_dropout: float = 0.1
    #: model init and dropout, and the data where ``data_seed`` is None
    jax_seed: int = 1919
    data_seed: Optional[int] = None
    epochs: int = 50
    warmup_end: int = 1
    early_stop_patience: int = 1000
    lr_factor: float = 4.0
    ssm_lr_base: float = 1e-3
    weight_decay: float = 0.04
    opt_config: str = "noBCdecay"
    dt_global: bool = False
    grad_clip_threshold: Optional[float] = None
    lr_min: float = 1e-6
    lr_schedule: str = "cosine"         # cosine | plateau
    plateau_factor: float = 0.2
    plateau_patience: int = 20
    pruning: str = "no_prune"           # a train/pruning.pruning_recipes name

    # --- parallelism (not ported: any other value raises) ---
    mesh_data: int = -1
    mesh_model: int = 1
    mesh_seq: int = 1

    @property
    def lr(self) -> float:
        return self.lr_factor * self.ssm_lr_base

    def apply_dim_scale(self) -> "RunConfig":
        """d_model and ssm_size_base times ``dim_scale`` (the state size
        rounded down to a multiple of 2 * blocks, at least ``blocks``), and
        ``dim_scale`` back to 1: the JAX package's formula."""
        if self.dim_scale == 1.0:
            return self
        s = self.dim_scale
        return dataclasses.replace(
            self,
            d_model=int(self.d_model * s),
            ssm_size_base=max(self.blocks,
                              int(self.ssm_size_base * s) // (2 * self.blocks)
                              * 2 * self.blocks),
            dim_scale=1.0,
        )

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


def _parse_bool(text: str) -> bool:
    return text.lower() in ("1", "true", "yes")


def _element_type(annotation) -> type:
    """The type of an ``Optional[...]`` field's values (annotations are
    strings under ``from __future__ import annotations``)."""
    text = str(annotation)
    if "float" in text:
        return float
    if "int" in text:
        return int
    return str


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """One ``--<field>`` flag per :class:`RunConfig` field, defaulting to
    the field's default (booleans parse "1", "true", "yes" as true)."""
    for f in dataclasses.fields(RunConfig):
        name = f"--{f.name}"
        if isinstance(f.default, bool):
            parser.add_argument(name, type=_parse_bool, default=f.default)
        elif f.default is None:
            parser.add_argument(name, type=_element_type(f.type),
                                default=None)
        else:
            parser.add_argument(name, type=type(f.default),
                                default=f.default)


def config_from_args(args: argparse.Namespace) -> RunConfig:
    """The :class:`RunConfig` of parsed flags (other attributes ignored)."""
    known = {f.name for f in dataclasses.fields(RunConfig)}
    return RunConfig(**{k: v for k, v in vars(args).items() if k in known})
