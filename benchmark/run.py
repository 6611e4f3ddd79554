"""Run one cell of the benchmark on the cards of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number the correctness check compared, with its limit (also the last
lines of standard error). Exits non-zero, with no result, where there is
no CUDA card, fewer cards than the cell asks for, the program is missing,
a rank fails, or JAX or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import spec
    spec.set_cache_dirs()
    cell = spec.cell(args.workload)
    import torch

    from benchmark.harness import core
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        out = core.run_cell(args.workload, core.seed_ok(args.seed),
                            args.seconds, bool(args.trace), T_START)
    except Exception as exc:  # noqa: BLE001 - reported, no result printed
        print(core.describe_failure(exc), file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
