"""Command-line entry point (counterpart of ``sparsernns_tpu/cli.py``):

    python -m sparsernns_tpu_torch.cli train   --recipe recipes/ndns.json ...
    python -m sparsernns_tpu_torch.cli convert --checkpoint_dir runs/x ...
    python -m sparsernns_tpu_torch.cli fxp     --checkpoint_dir runs/x \
        --fxp_mode inference|verify|export

Every :class:`~sparsernns_tpu_torch.utils.config.RunConfig` field is a
flag (``--<field> value``); a ``--recipe`` JSON file overlays the flags
(the recipe wins, as in the JAX package), then ``dim_scale`` rescales the
model. ``--device`` (default ``cuda``) is where the model runs. ``train``
runs every dataset of the registry (``--dataset ndns``,
``synthetic-classification``, ``smnist``, ``psmnist``); ``convert`` and
``fxp`` serve the NDNS task, as in the JAX package. ``fxp`` runs the
fixed-point golden engine over ``convert``'s artifacts
(``fxp/runner.py``).

``train`` on a device mesh: one process a rank under ``torchrun``, which
sets the process group's variables; ``--mesh_data``, ``--mesh_model``
and ``--mesh_seq`` shape the mesh (``parallel/``); the process group's
backend is ``nccl`` with ``--device cuda`` (a card a rank) and ``gloo``
with ``--device cpu``::

    torchrun --nproc_per_node 4 -m sparsernns_tpu_torch.cli train \
        --recipe recipes/ndns.json --mesh_data 2 --mesh_model 2
"""

from __future__ import annotations

import argparse
import logging
import sys

from sparsernns_tpu_torch.utils.config import add_config_args, \
    config_from_args

logger = logging.getLogger("sparsernns_tpu_torch")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("sparsernns_tpu_torch")
    parser.add_argument("command", choices=["train", "convert", "fxp"],
                        help="pipeline stage to run")
    parser.add_argument("--recipe", default=None,
                        help="JSON recipe overlay (see recipes/)")
    parser.add_argument("--fxp_mode", default="inference",
                        choices=["inference", "verify", "export"])
    parser.add_argument("--device", default="cuda",
                        help="device of the run: cuda (default) or cpu")
    add_config_args(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.recipe:
        cfg = cfg.with_recipe(args.recipe)
    cfg = cfg.apply_dim_scale()
    logging.basicConfig(level=logging.INFO)
    logger.info("command=%s device=%s config=%s", args.command, args.device,
                cfg)
    if args.command == "train":
        import torch.distributed as dist

        from sparsernns_tpu_torch.parallel.mesh import \
            maybe_initialize_distributed
        from sparsernns_tpu_torch.train.loop import train
        backend = "nccl" if args.device == "cuda" else "gloo"
        started = (not dist.is_initialized()
                   and maybe_initialize_distributed(backend))
        try:
            train(cfg, device=args.device)
        finally:
            if started:
                dist.destroy_process_group()
    elif args.command == "convert":
        from sparsernns_tpu_torch.quantize.convert import convert
        results = convert(cfg, device=args.device)
        logger.info("conversion results: %s", {
            k: v for k, v in results.items()
            if k not in ("frozen_params", "frozen_stats")})
    else:
        from sparsernns_tpu_torch.fxp import runner
        if args.fxp_mode == "inference":
            runner.run_inference(cfg, device=args.device)
        elif args.fxp_mode == "verify":
            runner.run_verification(cfg, device=args.device)
        else:
            runner.export_bundle(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
