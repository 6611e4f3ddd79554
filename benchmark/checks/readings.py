"""The readings a cell's correctness limits are set from, on the cards:
for each seed the numbers the check compares for the program, for the
control (the reference one precision below the configuration's, in the
program's place) and for each planted fault, in one process (one set-up
of the program's kernels). No measured window.

    python3 benchmark/checks/readings.py --workload <cell> \\
        --seeds 11,12,13 [--control] [--faults half_batch,state_unchanged]

Prints one JSON line per seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import spec
    spec.set_cache_dirs()
    import torch

    from benchmark.harness import core
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    how = {"seeds": [int(s) for s in args.seeds.split(",")],
           "control": args.control,
           "faults": [f for f in args.faults.split(",") if f]}
    t0 = time.time()
    rows = core.run_cell(args.workload, 0, 0.0, False, t0,
                         {"readings": how})
    for row in rows:
        print(json.dumps(row), flush=True)
    print(f"readings of {len(rows)} seeds in {time.time() - t0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
